"""The VSR replica: consensus participant + commit pipeline.

reference: src/vsr/replica.zig (normal protocol :1944-2330, commit pipeline
:4374-5440, view change per docs/internals/vsr.md:106-186). This is a fresh
sans-IO implementation: all effects go through injected Storage / MessageBus
/ Time, so the deterministic simulator can run whole clusters in-process
(the reference achieves the same via comptime injection,
src/testing/cluster.zig:70).

Protocol summary (faithful to VSR; simplified where noted):
- normal: primary assigns (op, timestamp) to client requests, appends to its
  journal, replicates `prepare` to backups; backups append + `prepare_ok`;
  primary commits on replication quorum, executes the state machine, replies
  to the client; backups learn commits from piggybacked `commit` numbers and
  heartbeat `commit` messages.
- view change: on primary timeout, replicas send `start_view_change` for
  view v+1; on quorum each sends `do_view_change` (carrying log_view, op,
  and the header suffix above the checkpoint) to v+1's primary; the new
  primary adopts the best log (max log_view, then max op), sends
  `start_view`; backups install the suffix and repair missing prepares.
- repair: gaps are filled via `request_prepare`/`prepare` from any peer.
- checkpoint: state-machine objects are written through to the LSM forest
  after every commit (vsr/durable.py), compaction is paced by op number, and
  every `checkpoint_interval` commits the forest checkpoints: manifests +
  free set serialize into a small root blob written to the alternating
  snapshot slot, then the superblock flips — an incremental checkpoint, like
  the reference's grid + checkpoint trailer (docs/internals/data_file.md).

State sync (docs/internals/sync.md): a replica that fell behind the WAL
wrap jumps to a peer's checkpoint — the peer offers its checkpoint root in
response to an unserviceable request_prepare, the lagging replica fetches
the reachable grid blocks (request_blocks/block) and installs checkpoint +
sessions + superblock atomically.

Standbys (ids >= replica_count) follow the replication stream and hold
checkpoints without voting — warm spares outside the quorums.

NACK / protocol-aware recovery (reference: quorum_nack_prepare,
src/vsr/replica.zig:254,825; docs/ARCHITECTURE.md:540-563): a new
primary whose chosen log has an unobtainable prepare (every copy lost or
corrupted) must decide whether the op could have committed. Peers that
can PROVE they never prepared it — their WAL slot holds nothing for the
op (and is not a torn write: a faulty slot abstains, it may be the very
prepare in question), or holds a different-checksum prepare (a replica
prepares at most one body per op) — answer request_prepare with
`nack_prepare`. Collecting `replica_count - quorum_replication + 1`
distinct nacks proves no replication quorum ever existed, so the op (and
the suffix above it, which chains through it) is truncated and the view
starts. Without this, "repairs when a good copy exists" is the best the
protocol can do; with it, an uncommitted-but-lost prepare can never
wedge a view change, while a committed prepare is never truncated (the
nack quorum intersects every replication quorum).

A copy of the JAX package's `vsr/replica.py`, wired onto the port's
StateMachine (whose device engine commits on the card), DurableState and
FileStorage as the JAX package wires its own: the same messages, WAL,
superblock, checkpoint roots and grid bytes for the same inputs.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

from .. import constants
from ..constants import PIPELINE_PREPARE_QUEUE_MAX
from ..state_machine import StateMachine, _base_operation
from ..trace import Event
from ..types import Operation
import struct

from .checksum import checksum
from .client_sessions import ClientSessions
from .durable import DurableState
from .fault_detector import FaultDetector
from .grid_scrubber import GridScrubber
from .header import HEADER_SIZE, Command, Header, Message
from .journal import Journal
from .repair_budget import RepairBudget
from .storage import Storage
from .superblock import SuperBlock

MS = 1_000_000  # ns


@dataclasses.dataclass
class ReplicaOptions:
    heartbeat_interval_ns: int = 100 * MS
    view_change_timeout_ns: int = 500 * MS
    repair_interval_ns: int = 50 * MS
    checkpoint_interval: int = 16  # ops between checkpoints


class Replica:
    def __init__(self, *, cluster: int, replica_id: int, replica_count: int,
                 storage: Storage, bus, time,
                 state_machine_factory: Callable[[], StateMachine] = StateMachine,
                 options: ReplicaOptions = ReplicaOptions(),
                 tracer=None, aof=None, standby_count: int = 0):
        from ..multiversion import RELEASE, ReleaseTracker
        from ..trace import NullTracer
        from .clock import Clock

        assert 1 <= replica_count <= 6
        assert 0 <= standby_count <= 6
        # Standbys (ids >= replica_count) receive the replication stream
        # and commit like backups, but hold no vote: they never ack
        # prepares, never join view changes, never become primary
        # (reference: docs/ARCHITECTURE.md standbys — extra durability and
        # warm spares without quorum cost).
        assert 0 <= replica_id < replica_count + standby_count
        self.standby_count = standby_count
        self.is_standby = replica_id >= replica_count
        self.tracer = tracer if tracer is not None else NullTracer()
        self.aof = aof
        self.release = RELEASE
        # own= explicitly: the dataclass default binds the module RELEASE
        # at class-definition time, which would go stale across an
        # in-process upgrade (rolling-upgrade test).
        self.releases = ReleaseTracker(own=self.release)
        self.clock = Clock(replica_id, replica_count, time)
        self.last_ping_tx = 0
        self.cluster = cluster
        self.replica_id = replica_id
        self.replica_count = replica_count
        self.storage = storage
        self.bus = bus
        self.time = time
        self.options = options
        self.state_machine_factory = state_machine_factory

        from ..constants import config_fingerprint

        # Cluster-config fingerprint (constants + THIS replica's storage
        # geometry), cached: exchanged on pings, enforced in on_message.
        self._config_fp = config_fingerprint(
            (storage.layout.slot_count, storage.layout.message_size_max,
             storage.layout.grid_block_size))
        # Peers whose fingerprint mismatched: ALL their replica-to-replica
        # traffic is dropped until a matching ping clears them.
        self._config_mismatch: set[int] = set()
        self.journal = Journal(storage, tracer=self.tracer)
        self.state_machine: StateMachine = state_machine_factory()
        self.durable = DurableState(storage)
        # Serve reads from the LSM with a bounded object cache
        # (state_machine.attach_durable; reference: groove object cache).
        self.state_machine.attach_durable(self.durable)
        # Standing missing-block tracker (reference: grid_blocks_missing):
        # a corrupt read ANYWHERE (serving path, not just the scrubber)
        # queues the block for peer repair.
        self.durable.grid.on_corrupt = self._note_missing_block
        self.superblock: Optional[SuperBlock] = None
        self.fault_detector = FaultDetector(suspect_multiplier=4.0)
        self.repair_budget = RepairBudget()
        # Origin spread: each replica tours the grid from a different
        # rotation so the same latent fault is scrubbed at different
        # times on different replicas (grid_scrubber.zig:170-182).
        self.scrubber = GridScrubber(
            self.durable.forest,
            origin_seed=replica_id * 2654435761, tracer=self.tracer)
        self._scrub_phase = 0

        self.status = "recovering"
        # Rebuild-from-cluster mode (reference: src/vsr/replica_reformat
        # .zig): a replica whose data file was lost/zeroed re-enters the
        # cluster WITHOUT a vote — it solicits a peer checkpoint, installs
        # it via state sync (staged: superblock sync_op brackets the grid
        # writes), repairs the WAL suffix through normal VSR repair, and
        # certifies the installed grid with a full scrub tour before it is
        # allowed to ack, nack, or elect again. Its lost promises are only
        # safe to forget because it rejoins at/above the cluster's durable
        # checkpoint while a healthy quorum carries the log.
        self.rebuilding = False
        self._rebuild_goal = 0  # cluster commit to catch up to (frozen)
        self._rebuild_heard = False  # a peer answered the solicitation
        self._rebuild_synced = False  # a checkpoint install happened
        self._rebuild_certified = False  # full scrub tour came back clean
        self._rebuild_solicit_last = 0
        self._rebuild_certify_last = 0
        self.view = 0
        self.log_view = 0
        self.op = 0  # highest op appended to our journal
        self.commit_min = 0  # highest op executed
        self.commit_max = 0  # highest op known committed cluster-wide
        self.prepare_timestamp = 0

        # Primary pipeline: op -> {"message": Message, "oks": set[replica]}
        self.pipeline: dict[int, dict] = {}
        # Durable session table + latest replies (client_replies zone).
        self.sessions = ClientSessions(storage)
        # View change collection state.
        self.svc_votes: dict[int, set[int]] = {}
        self.dvc_messages: dict[int, dict[int, Message]] = {}
        # Canonical HEADERS installed from start_view/do_view_change:
        # prepares matching their checksums are authoritative regardless of
        # their view (the view-change quorum chose this log). Full headers
        # are kept so a new primary can broadcast the canonical suffix even
        # before it repairs the bodies.
        self.canonical: dict[int, Header] = {}
        # Repair bookkeeping.
        self.repair_requested: dict[int, int] = {}  # op -> last request ns
        # State-sync progress (None when not syncing).
        self.syncing: Optional[dict] = None
        # A view this (new primary) replica is completing repair for,
        # before broadcasting start_view.
        self._pending_view: Optional[int] = None
        # Ops below this are unverifiable from our journal (a start_view's
        # suffix began beyond them): execute only canonical entries there.
        self.sync_floor = 0
        # Checkpoint-rollback recovery: at most one attempt per
        # (checkpoint, log_view) — re-divergence against the SAME
        # canonical knowledge proves the checkpoint itself diverged (only
        # state sync can help), while a later view's new canonical suffix
        # legitimately warrants a fresh attempt.
        self._rollback_checkpoint: tuple[int, int] | None = None
        # op -> monotonic time it entered rollback quarantine; lingering
        # entries escalate to the state-sync path.
        self._suspect_since: dict[int, int] = {}
        # op -> re-request count; stalled repairs re-solicit the current
        # view's start_view (canonical anchor) every 8th attempt
        # (throttled to one solicitation per interval, replica-wide).
        self._repair_attempts: dict[int, int] = {}
        self._rsv_last = 0
        # Ops the DVC merge could not resolve (same-log_view conflict
        # with no chain pin): the view must NOT finalize over them — the
        # view-change timer escalates to the next view instead, where a
        # different electorate can resolve the fork.
        self._dvc_ambiguous: set[int] = set()
        # Ops whose journaled prepare failed the forward-chain check (a
        # stale leftover under a committed op number): repair must fetch a
        # replacement even though a prepare is held.
        self.chain_suspect: set[int] = set()
        self._windows_committed = 0  # commit-window aggregations served
        # NACK collection (pending-view primary only): op -> set[replica]
        # of peers proving they never prepared the canonical entry.
        self.nacks: dict[int, set[int]] = {}
        # Scrub-detected corrupt blocks awaiting peer repair:
        # block index -> (tree, address, size).
        self.block_repair: dict[int, tuple] = {}
        self._reply_repair_last = 0

        self.last_heartbeat_rx = 0
        self.last_heartbeat_tx = 0
        self.last_repair_tick = 0
        # Commit-progress watchdog (send-only-primary liveness).
        self._progress_commit = 0
        self._progress_view = 0
        self._progress_ts = 0

    # ------------------------------------------------------------ lifecycle

    @staticmethod
    def format(storage: Storage, *, cluster: int, replica_id: int,
               replica_count: int) -> None:
        """Create a fresh data file (reference: src/vsr/replica_format.zig):
        an empty forest checkpoint root + the genesis superblock."""
        from ..multiversion import RELEASE

        durable = DurableState(storage)
        sessions_blob = ClientSessions(storage).pack()
        # The empty state: an oracle engine's on the CPU, which holds
        # nothing on a card (format runs with or without one).
        root = (durable.checkpoint(
                    StateMachine(engine="oracle", device="cpu").state)
                + sessions_blob + struct.pack("<I", len(sessions_blob)))
        storage.write("snapshot", 0, root)
        # Format the WAL header ring with valid RESERVED headers
        # (reference: src/vsr/replica_format.zig formats every slot): a
        # recovering journal can then distinguish formatted-empty slots
        # (provably never prepared — eligible to NACK) from torn writes
        # (faulty — must abstain).
        for slot in range(storage.layout.slot_count):
            reserved = Header(command=Command.reserved, cluster=cluster,
                              replica=replica_id, op=slot).finalize()
            storage.write("wal_headers", slot * HEADER_SIZE, reserved.pack())
        sb = SuperBlock(
            cluster=cluster, replica_id=replica_id,
            replica_count=replica_count, release=RELEASE,
            snapshot_slot=0, snapshot_size=len(root),
            snapshot_checksum=checksum(root, domain=b"ckptroot"))
        sb.store(storage)

    def open(self) -> None:
        """Recover durable state: superblock quorum -> snapshot -> WAL replay
        (reference: src/vsr/replica.zig:654 open + commit_journal)."""
        sb = SuperBlock.load(self.storage)
        assert sb is not None, "data file not formatted"
        assert sb.cluster == self.cluster
        assert sb.replica_id == self.replica_id
        if sb.sync_op:
            # A state-sync install was torn by a crash: the grid may hold
            # a mix of old- and new-checkpoint blocks. Half-installed
            # state must never serve reads or vote — only the rebuild
            # path (which re-validates every block it keeps) may open it.
            raise RuntimeError(
                f"data file is mid-rebuild (state-sync install to op "
                f"{sb.sync_op} was interrupted) — run "
                "`recover --from-cluster` to finish the rebuild")
        if not self.releases.openable(sb.release):
            if self.releases.compatible(sb.release):
                raise RuntimeError(
                    f"data file checkpointed by release {sb.release} is "
                    f"below this binary's format floor — rebuild it via "
                    "`recover` (r2 changed the index-tree schema)")
            raise RuntimeError(
                f"data file checkpointed by release {sb.release}; this "
                f"binary is release {self.release} — upgrade before starting "
                "(reference: multiversion re-exec decision)")
        self.superblock = sb
        self.view = sb.view
        self.log_view = sb.log_view

        root = self.storage.read(
            "snapshot", sb.snapshot_slot * self.storage.layout.snapshot_size_max,
            sb.snapshot_size)
        assert checksum(root, domain=b"ckptroot") == sb.snapshot_checksum, \
            "checkpoint root corrupt"
        # Root layout: forest-root || sessions-blob || u32 sessions length
        # (reference: checkpoint trailer carries the client sessions too).
        forest_root, sessions_blob = _split_root(root)
        self.sessions.restore(sessions_blob)
        self.state_machine = self.state_machine_factory()
        self.state_machine.state = self.durable.open(forest_root,
                                                     load_events=False)
        self.state_machine.attach_durable(self.durable)

        self.journal.recover()
        self.op = max(sb.op_checkpoint, self._journal_contiguous_max(sb.op_checkpoint))
        self.commit_min = sb.op_checkpoint
        self.commit_max = max(sb.commit_max, sb.op_checkpoint)
        self.prepare_timestamp = self.state_machine.state.commit_timestamp
        # Replay the WAL suffix above the checkpoint — but only up to the
        # durably-KNOWN commit point. A primary that COMPLETED its view's
        # change (log_view == view) provably holds the canonical log up to
        # that commit point (it verified its journal against the chosen
        # log before start_view, and every later entry is its own), so it
        # replays fully — prepares legitimately keep their original older
        # views, which is why a view filter alone would wedge it. Everyone
        # else stops at the first entry not written under sb.log_view: it
        # may be a stale leftover a view change replaced while we were
        # down (the canonical/sync-floor guards are volatile); deferred
        # entries re-commit through the live protocol once we rejoin.
        own_primary = (self.primary_index(sb.view) == self.replica_id
                       and sb.log_view == sb.view and not self.is_standby)
        replay_to = min(self.op, self.commit_max)
        if not own_primary:
            for op in range(sb.op_checkpoint + 1, replay_to + 1):
                m = self.journal.read_prepare(op)
                if m is None or m.header.view != sb.log_view:
                    replay_to = op - 1
                    break
        self._commit_journal(replay_to)
        if sb.log_view < sb.view:
            # We persisted a view we never completed (crashed mid
            # view-change): we hold no proof of that view's log — rejoining
            # as view_change defers everything to the live protocol, and
            # crucially prevents acting as that view's primary without a
            # do_view_change quorum.
            self.status = "view_change"
        else:
            self.status = "normal"
        self.last_heartbeat_rx = self.time.monotonic()
        if self.is_primary:
            # Re-install canonical headers on the backups (their canonical
            # sets died with their processes; without this they drop our
            # old-view prepares), then re-replicate our uncommitted suffix
            # so it regains a quorum (single-replica clusters commit it
            # immediately: quorum 1). If the cluster moved to a newer view
            # while we were down, backups ignore both (view guards) and we
            # learn the new view from their traffic instead.
            self._broadcast_start_view()
            for op in range(self.commit_min + 1, self.op + 1):
                m = self.journal.read_prepare(op)
                if m is not None:
                    self._primary_adopt_canonical(m)

    def open_rebuild(self) -> None:
        """Open a blank / suspect data file for rebuild-from-cluster
        (reference: src/vsr/replica_reformat.zig): (re)format if the file
        is unformatted, mid-install (sync_op), or its checkpoint root is
        corrupt, then open passively. The grid zone survives a reformat —
        every block a later sync install reuses is validated against the
        offered root's checksums, so blocks fetched before a crash resume
        the transfer for free (delta sync) while clobbered ones are simply
        re-fetched."""
        sb = SuperBlock.load(self.storage)
        needs_format = (sb is None or sb.sync_op != 0
                        or sb.cluster != self.cluster
                        or sb.replica_id != self.replica_id)
        if not needs_format:
            root = self.storage.read(
                "snapshot",
                sb.snapshot_slot * self.storage.layout.snapshot_size_max,
                sb.snapshot_size)
            if checksum(root, domain=b"ckptroot") != sb.snapshot_checksum:
                needs_format = True
        if needs_format:
            Replica.format(self.storage, cluster=self.cluster,
                           replica_id=self.replica_id,
                           replica_count=self.replica_count)
        self.rebuilding = True
        self.tracer.begin(Event.rebuild)
        self.open()
        # A persisted log_view < view would open as "view_change", whose
        # liveness branch elects — a rebuilding replica never does. It
        # follows the live electorate passively and adopts whatever view
        # the cluster's start_view teaches it.
        self.status = "normal"

    @property
    def rebuild_complete(self) -> bool:
        """The rebuild reached its frozen goal: checkpoint installed (or
        reachable via WAL repair), committed up to the cluster commit
        observed at first contact, and the grid certified by a clean full
        scrub tour."""
        return (self.rebuilding and self._rebuild_heard
                and self.syncing is None
                and self.commit_min >= self._rebuild_goal
                and self._rebuild_certified)

    def finish_rebuild(self) -> None:
        """Re-enter the voting set (only once the rebuild is complete)."""
        assert self.rebuild_complete
        self.rebuilding = False
        self.tracer.end(Event.rebuild)

    def rebuild_progress(self) -> str:
        """One-line operator-facing progress (recover --from-cluster)."""
        if self.syncing is not None:
            have = len(self.syncing["have"])
            return (f"syncing checkpoint op {self.syncing['target_op']} "
                    f"from r{self.syncing['source']}: {have} blocks "
                    f"staged, {len(self.syncing['needed'])} to fetch")
        if not self._rebuild_heard:
            return "soliciting a checkpoint from the cluster"
        if self.commit_min < self._rebuild_goal:
            return (f"repairing WAL suffix: commit {self.commit_min}/"
                    f"{self._rebuild_goal}")
        if not self._rebuild_certified:
            return (f"certifying grid ({len(self.block_repair)} "
                    "blocks awaiting peer repair)")
        return (f"complete: checkpoint op "
                f"{self.superblock.op_checkpoint}, commit "
                f"{self.commit_min}")

    def _rebuild_tick(self, now: int) -> None:
        """Drive the rebuild: solicit a checkpoint until a peer answers,
        then certify the installed grid once caught up. The actual data
        movement rides the existing machinery (sync offers, block fetch,
        WAL repair)."""
        if (self.syncing is None
                and not (self._rebuild_heard
                         and self.commit_min >= self._rebuild_goal)
                and now - self._rebuild_solicit_last
                >= 4 * self.options.repair_interval_ns):
            # context=1: "I cannot trust any served prepare" — a peer
            # whose checkpoint covers the op answers with a sync offer,
            # the primary answers with start_view otherwise.
            self._rebuild_solicit_last = now
            header = Header(
                command=Command.request_prepare, cluster=self.cluster,
                replica=self.replica_id, view=self.view,
                op=self.commit_min + 1, context=1)
            msg = Message(header.finalize())
            for r in range(self.peer_count):
                if r != self.replica_id:
                    self.bus.send_to_replica(r, msg)
        if (self.syncing is None and self._rebuild_heard
                and self.commit_min >= self._rebuild_goal
                and not self._rebuild_certified
                and not self.block_repair
                and now - self._rebuild_certify_last
                >= 8 * self.options.repair_interval_ns):
            # Post-rebuild certification: one immediate full scrub tour.
            # Faults queue for peer repair (within the repair budget);
            # only a tour with zero faults AND an empty repair queue
            # certifies.
            self._rebuild_certify_last = now
            faults = self.scrubber.certify()
            for name, address, size in faults:
                self.block_repair[address.index] = (name, address, size)
            if not faults:
                self._rebuild_certified = True

    def _journal_contiguous_max(self, from_op: int) -> int:
        """Highest op such that every (from_op, op] slot holds a valid,
        hash-chained prepare."""
        op = from_op
        while True:
            nxt = self.journal.read_prepare(op + 1)
            if nxt is None:
                return op
            if op > from_op:
                cur = self.journal.read_prepare(op)
                if cur is None or nxt.header.parent != cur.header.checksum:
                    return op
            op += 1

    # ------------------------------------------------------------ identity

    def primary_index(self, view: Optional[int] = None) -> int:
        return (self.view if view is None else view) % self.replica_count

    @property
    def is_primary(self) -> bool:
        # A rebuilding replica is never primary, whatever the view math
        # says: half-installed state must not serve reads or assign ops.
        return (self.status == "normal"
                and self.primary_index() == self.replica_id
                and not self.rebuilding)

    @property
    def peer_count(self) -> int:
        """All message-reachable replicas: active + standbys."""
        return self.replica_count + self.standby_count

    @property
    def quorum_replication(self) -> int:
        """Flexible quorums (reference: docs/internals/vsr.md:283-289)."""
        return {1: 1, 2: 2, 3: 2, 4: 2, 5: 3, 6: 3}[self.replica_count]

    @property
    def quorum_nack(self) -> int:
        """Nacks that prove an op never reached a replication quorum: if it
        had, at most replica_count - quorum_replication replicas could
        truthfully lack it (reference: docs/ARCHITECTURE.md:540-563)."""
        return self.replica_count - self.quorum_replication + 1

    @property
    def quorum_view_change(self) -> int:
        return {1: 1, 2: 2, 3: 2, 4: 3, 5: 3, 6: 4}[self.replica_count]

    # ------------------------------------------------------------- messages

    def on_message(self, msg: Message) -> None:
        if not msg.valid():
            return
        h = msg.header
        if h.cluster != self.cluster:
            return
        if (h.replica in self._config_mismatch
                and h.command not in (Command.request, Command.ping)):
            # A config-mismatched peer must not participate in consensus
            # (its geometry could corrupt journals/quorum math); pings
            # stay visible so a fixed peer can clear the flag, and
            # `request` is exempt because clients default to
            # header.replica=0, which can collide with a replica id.
            return
        handler = {
            Command.request: self.on_request,
            Command.prepare: self.on_prepare,
            Command.prepare_ok: self.on_prepare_ok,
            Command.commit: self.on_commit,
            Command.start_view_change: self.on_start_view_change,
            Command.do_view_change: self.on_do_view_change,
            Command.start_view: self.on_start_view,
            Command.request_start_view: self.on_request_start_view,
            Command.request_prepare: self.on_request_prepare,
            Command.request_reply: self.on_request_reply,
            Command.reply: self.on_reply,
            Command.headers: self.on_sync_offer,
            Command.request_blocks: self.on_request_blocks,
            Command.block: self.on_block,
            Command.nack_prepare: self.on_nack_prepare,
            Command.ping: self.on_ping,
            Command.pong: self.on_pong,
        }.get(h.command)
        if handler is not None:
            handler(msg)

    # --------------------------------------------------------- normal path

    def on_request(self, msg: Message) -> None:
        if not self.is_primary:
            return  # client retries against the right primary
        h = msg.header
        try:
            operation = Operation(h.operation)
        except ValueError:
            return  # unknown operation: drop, never crash the replica
        session = self.sessions.get(h.client)
        if session is not None:
            if h.request < session["request"]:
                return  # stale duplicate
            if h.request == session["request"]:
                if session["reply"] is not None:
                    self.bus.send_to_client(h.client, session["reply"])
                else:
                    # Reply bytes missing locally (torn slot / state sync):
                    # repair from peers; the client's retry answers then.
                    self._request_reply_repair(h.client)
                return
        for entry in self.pipeline.values():
            eh = entry["message"].header
            if eh.client == h.client and eh.request == h.request:
                return  # already preparing this request
        if len(self.pipeline) >= PIPELINE_PREPARE_QUEUE_MAX:
            return  # backpressure: client will retry
        if HEADER_SIZE + len(msg.body) > self.storage.layout.message_size_max:
            return  # would not fit THIS replica's journal slot (small layout)
        if not _reply_fits(operation, len(msg.body),
                           self.storage.layout.message_size_max):
            return  # worst-case reply would not fit a message/reply slot
        if not self.state_machine.input_valid(operation, msg.body):
            return  # malformed body: never prepare it (client bug)
        self._primary_prepare(operation, msg.body, client=h.client,
                              request=h.request, ctx=h.trace_ctx)

    def _primary_prepare(self, operation: Operation, body: bytes, *,
                         client: int = 0, request: int = 0,
                         ctx=None) -> None:
        assert self.is_primary
        op = self.op + 1
        # Consensus drives time, not vice versa (reference clock.zig:1-45;
        # replica.zig prepare_timestamp via realtime_synchronized): a
        # primary without Marzullo agreement from a quorum of fresh clock
        # samples must NOT stamp prepares — it drops the request and the
        # client retries (a multi-replica cluster with an unsynchronizable
        # primary makes no progress, replica_test.zig "primary no clock
        # sync"). A solo replica is trivially synchronized with itself.
        if self.replica_count > 1:
            now = self.clock.realtime_synchronized()
            if now is None:
                return
        else:
            now = self.time.realtime()
        self.prepare_timestamp = max(
            self.prepare_timestamp + _event_count(operation, body), now)
        parent = self._prepare_checksum(self.op)
        header = Header(
            command=Command.prepare, cluster=self.cluster,
            replica=self.replica_id, view=self.view, op=op,
            commit=self.commit_max, timestamp=self.prepare_timestamp,
            operation=int(operation), client=client, request=request,
            parent=parent, release=self.release,
            # The request's trace context rides the prepare to the
            # backups (their replication spans parent to the client's
            # root span) and — derived ONLY from prepare fields — into
            # the reply, keeping replies byte-identical across replicas.
            trace_ctx=ctx,
        )
        prepare = Message(header=header.finalize(body), body=body)
        self.op = op
        self.pipeline[op] = {"message": prepare, "oks": set(),
                             "ctx": ctx, "t0": self.tracer.now_ns()}
        # The local journal write and the network replication proceed
        # CONCURRENTLY (reference: src/io/linux.zig overlap); the primary
        # counts its own ack only once its WAL slot is durable.
        self.journal.append(prepare, on_durable=self._self_ack_fn(prepare))
        for r in range(self.peer_count):
            if r != self.replica_id:
                self.bus.send_to_replica(r, prepare)
        self._check_quorum(op)

    def _self_ack_fn(self, prepare: Message):
        op, csum = prepare.header.op, prepare.header.checksum
        def _ack():
            entry = self.pipeline.get(op)
            if entry is not None and entry["message"].header.checksum == csum:
                entry["oks"].add(self.replica_id)
                self._check_quorum(op)
        return _ack

    def _prepare_checksum(self, op: int) -> int:
        if op == 0:
            return checksum(
                self.cluster.to_bytes(16, "little"), domain=b"genesis")
        msg = self.journal.read_prepare(op)
        return msg.header.checksum if msg else 0

    def on_prepare(self, msg: Message) -> None:
        h = msg.header
        # Causal tracing: a backup's replication span runs from receipt
        # to the durable-slot ack (recorded in _send_prepare_ok).
        t0 = self.tracer.now_ns()
        # A prepare matching a canonical header (installed by the view-change
        # quorum) is authoritative regardless of its original view.
        want_hdr = self.canonical.get(h.op)
        if (want_hdr is not None and want_hdr.checksum == h.checksum
                and self.status in ("normal", "view_change")):
            held = self.journal.read_prepare(h.op)
            if held is None or held.header.checksum != h.checksum:
                self.journal.append(msg)  # overwrite a stale same-op prepare
            self.op = max(self.op, h.op)
            if self.is_standby or self.rebuilding \
                    or self._pending_view is not None:
                pass  # no vote; a pending primary finalizes below instead
            elif not self.is_primary:
                self.journal.on_slot_durable(
                    h.op, lambda h=h, t0=t0: self._send_prepare_ok(h, t0))
            else:
                self._primary_adopt_canonical(msg)
            self._commit_journal(self.commit_max)
            return
        if self.status != "normal" or h.view != self.view:
            if h.view > self.view:
                self._request_start_view(h.view)
            return
        if self.is_primary:
            return
        self.last_heartbeat_rx = self.time.monotonic()
        self.fault_detector.observe_progress(self.last_heartbeat_rx)
        if h.op <= self.op:
            held = self.journal.read_prepare(h.op)
            replace_suspect = (
                held is not None and h.op in self.chain_suspect
                and held.header.checksum != h.checksum)
            if (held is None or replace_suspect) and self._chains_into_log(h):
                # Repair fill: the prepare for a gap slot — or the
                # replacement for a stale chain-suspect leftover — validated
                # by its hash-chain linkage to neighbors we already hold.
                self.journal.append(msg)
                self.op = max(self.op, h.op)
                self.chain_suspect.discard(h.op)
                held = msg
                self._commit_journal(self.commit_max)
            if held is not None and held.header.checksum == h.checksum \
                    and not self.is_standby and not self.rebuilding:
                # Ack only what we actually hold — and only once the slot
                # is durable (an in-flight async append is not yet ours
                # to vouch for).
                self.journal.on_slot_durable(
                    h.op, lambda h=h, t0=t0: self._send_prepare_ok(h, t0))
        elif h.op == self.op + 1 and h.parent == self._prepare_checksum(self.op):
            self.journal.append(
                msg, on_durable=(
                    None if self.is_standby or self.rebuilding
                    else lambda h=h, t0=t0: self._send_prepare_ok(h, t0)))
            self.op = h.op
        else:
            # Gap or chain break: repair.
            for missing in range(self.op + 1, h.op):
                self.repair_requested.setdefault(missing, 0)
            self.journal.append(msg)  # keep the prepare; chain checked later
            self.op = max(self.op, h.op)
        self.commit_max = max(self.commit_max, h.commit)
        self._commit_journal(self.commit_max)

    def _chains_into_log(self, h: Header) -> bool:
        """Validate a repair prepare by hash-chain linkage. Forward linkage
        (op+1's parent pins this checksum) is authoritative at any view;
        backward linkage is only safe within the current view — an op
        replaced during a view change chains backward identically to its
        canonical replacement, so a stale prepare from a deposed primary
        must not be admitted that way."""
        nxt = self.journal.read_prepare(h.op + 1)
        if nxt is not None:
            return nxt.header.parent == h.checksum
        if h.op == 0 or h.view != self.view:
            return False
        prev_checksum = self._prepare_checksum(h.op - 1)
        return prev_checksum != 0 and h.parent == prev_checksum

    def _primary_adopt_canonical(self, msg: Message) -> None:
        """New primary obtained a canonical suffix prepare body: re-replicate
        it in the new view so it can gather a fresh quorum."""
        op = msg.header.op
        if op <= self.commit_min or op in self.pipeline:
            return
        # Replay path: the re-replicated prepare keeps its ORIGINAL
        # trace context, so the new quorum wait re-links to the same
        # request trace instead of orphaning it.
        self.pipeline[op] = {"message": msg, "oks": set(),
                             "ctx": msg.header.trace_ctx,
                             "t0": self.tracer.now_ns()}
        self.journal.on_slot_durable(op, self._self_ack_fn(msg))
        for r in range(self.peer_count):
            if r != self.replica_id:
                self.bus.send_to_replica(r, msg)
        self._check_quorum(op)

    def _send_prepare_ok(self, prepare_header: Header,
                         t0: int = 0) -> None:
        ctx = prepare_header.trace_ctx
        if ctx is not None and t0:
            self.tracer.record_span(
                Event.replica_ack, t0, self.tracer.now_ns() - t0,
                ctx=ctx, op=prepare_header.op)
        ok = Header(
            command=Command.prepare_ok, cluster=self.cluster,
            replica=self.replica_id, view=self.view, op=prepare_header.op,
            context=prepare_header.checksum,
            commit=self.commit_min,
        )
        self.bus.send_to_replica(self.primary_index(), Message(ok.finalize()))

    def on_prepare_ok(self, msg: Message) -> None:
        if not self.is_primary or msg.header.view != self.view:
            return
        entry = self.pipeline.get(msg.header.op)
        if entry is None:
            return
        if msg.header.context != entry["message"].header.checksum:
            return
        entry["oks"].add(msg.header.replica)
        self._check_quorum(msg.header.op)

    def _check_quorum(self, op: int) -> None:
        """Commit in order as quorums complete (reference commit_dispatch)."""
        while True:
            # The primary's prefetch stage: its prepare comes from the
            # in-memory pipeline, not a journal read — the span still
            # measures the fetch + quorum check so all four commit
            # stages appear on every replica's trace.
            with self.tracer.span(Event.commit_prefetch,
                                  op=self.commit_min + 1):
                entry = self.pipeline.get(self.commit_min + 1)
                ready = (entry is not None and
                         len(entry["oks"]) >= self.quorum_replication)
            if not ready:
                return
            # The explicit quorum-wait span: prepare fan-out
            # to quorum reached, parented to the request's root — read
            # from the entry BEFORE it leaves the pipeline.
            ctx = entry.get("ctx")
            if ctx is not None:
                t0 = entry.get("t0", 0)
                self.tracer.record_span(
                    Event.commit_quorum, t0, self.tracer.now_ns() - t0,
                    ctx=ctx, op=self.commit_min + 1)
            self.commit_max = max(self.commit_max, self.commit_min + 1)
            self._commit_op(entry["message"])
            del self.pipeline[self.commit_min]

    def on_commit(self, msg: Message) -> None:
        if self.status != "normal" or msg.header.view != self.view:
            if msg.header.view > self.view:
                self._request_start_view(msg.header.view)
            return
        if self.is_primary:
            return
        self.last_heartbeat_rx = self.time.monotonic()
        self.fault_detector.observe_progress(self.last_heartbeat_rx)
        self.commit_max = max(self.commit_max, msg.header.commit)
        self._commit_journal(self.commit_max)

    def _commit_journal(self, commit_target: int) -> None:
        """Execute committed prepares from the journal, in order, as far as
        we have them (reference: commit_journal :4310). A journaled prepare
        that contradicts a canonical header (stale op from a deposed
        primary) must be repaired, never executed. Two further guards
        against stale leftovers (a prepare the old view wrote but the
        cluster later committed DIFFERENTLY under the same op number):
        - sync floor: a start_view whose suffix begins beyond our position
          means our journal entries below it are unverifiable (the
          electorate checkpointed past them) — never execute them; repair
          leads to a state-sync offer instead;
        - forward chain: if the successor prepare is already journaled (and
          not itself contradicted by a canonical header), this op's
          checksum must be its parent — a mismatch means one of the two is
          stale, so repair rather than execute."""
        prev_checksum = None
        window_backoff = False
        while self.commit_min < commit_target:
            op = self.commit_min + 1
            with self.tracer.span(Event.commit_prefetch, op=op):
                msg = self.journal.read_prepare(op)
            want_hdr = self.canonical.get(op)
            want = None if want_hdr is None else want_hdr.checksum
            if msg is None or (want is not None
                               and msg.header.checksum != want):
                self.repair_requested.setdefault(op, 0)
                return
            if want is None and op < self.sync_floor:
                # Unverifiable leftover below the electorate's checkpoint.
                self.repair_requested.setdefault(op, 0)
                return
            if op in self.chain_suspect:
                # Quarantined (e.g. the rollback range): a stale chain can
                # share ancestry with the truth up to its fork, so parent
                # linkage alone cannot clear it. A canonical match IS the
                # confirmation (the mismatch case returned above);
                # otherwise execution waits for a replacement or a
                # forward-chain confirmation from a trusted op above
                # (repair tick).
                if want is None:
                    self.repair_requested.setdefault(op, 0)
                    return
                self.chain_suspect.discard(op)
            if prev_checksum is None:
                # 0 = base unknown (e.g. the op behind a synced checkpoint
                # is not in our journal): the tripwire can't fire there.
                prev_checksum = self._prepare_checksum(self.commit_min)
            if prev_checksum and msg.header.parent != prev_checksum:
                if want is not None:
                    # The CANONICAL prepare doesn't chain from what we
                    # executed: our own prefix diverged (we executed a
                    # deposed primary's prepare under a reused op number).
                    # Recovery, in preference order:
                    #   1. checkpoint rollback + re-execution: reload the
                    #      last persisted checkpoint (a pure function of
                    #      the committed prefix IF that prefix was
                    #      canonical), quarantine the stale journal range,
                    #      and let peer repairs — validated by forward
                    #      hash-chaining down from the canonical suffix —
                    #      replace and re-execute it;
                    #   2. if the rollback was already tried at this
                    #      checkpoint (the checkpoint itself diverged) or
                    #      the checkpoint doesn't precede the divergence:
                    #      refuse to execute (sync floor) and solicit a
                    #      state-sync offer once a peer checkpoint covers
                    #      us. Divergence is always preferred stalled over
                    #      executed.
                    if self._rollback_to_checkpoint(op):
                        return
                    self.sync_floor = max(self.sync_floor,
                                          max(self.commit_max, op) + 1)
                    self.canonical.pop(op, None)
                else:
                    # Backward-chain tripwire: a prepare that doesn't chain
                    # from the op we just committed is a stale leftover.
                    self.chain_suspect.add(op)
                self.repair_requested.setdefault(op, 0)
                return
            self.chain_suspect.discard(op)
            window = (None if window_backoff
                      else self._collect_commit_window(msg, commit_target))
            if window is not None:
                # Fan-in across batching: the window span joins the
                # FIRST traced constituent's tree and links every
                # member's trace id, so each request's trace crosses
                # the batch boundary and back out to its reply.
                wctxs = [m.header.trace_ctx for m in window]
                with self.tracer.span(
                        Event.commit_execute, op=window[0].header.op,
                        ctx=next((c for c in wctxs if c is not None),
                                 None),
                        operation=int(window[0].header.operation),
                        window=len(window)) as wsp:
                    for c in wctxs:
                        if c is not None:
                            wsp.link(c.trace_id)
                    out = self.state_machine.commit_window(
                        Operation(window[0].header.operation),
                        [m.body for m in window],
                        [m.header.timestamp for m in window],
                        all_or_nothing=True)
                if out is None:
                    # Cross-prepare dependency in this suffix: stop
                    # attempting windows for the rest of this call (the
                    # per-op path handles it exactly; retrying per
                    # iteration would pay a doomed dispatch per op).
                    window_backoff = True
                if out is not None:
                    replies, shape = out
                    self.tracer.count(Event.commit_windows)
                    self._windows_committed += 1
                    for m, res, k in zip(window, replies, shape):
                        self._post_commit(m, res, chunk_count=k)
                    prev_checksum = window[-1].header.checksum
                    continue
            self._commit_op(msg)
            prev_checksum = msg.header.checksum

    def _rollback_to_checkpoint(self, first_divergent_op: int) -> bool:
        """In-process checkpoint rollback for divergence recovery: reload
        the last persisted checkpoint's state (forest, sessions, state
        machine) exactly as a restart would, rewind commit_min to it, and
        quarantine the stale journal range (chain_suspect) so repairs can
        replace it with prepares that forward-chain from the canonical
        suffix. Returns False when rollback cannot help: no superblock, a
        corrupt snapshot, a checkpoint at/after the divergence, or a prior
        attempt at this same checkpoint (re-divergence proves the
        checkpoint itself is off the canonical history — the sync-floor /
        state-sync path is then the only recovery).

        Soundness: the rolled-back state re-executes ONLY prepares that
        hash-chain down from view-change-quorum-installed canonical
        headers; if our checkpoint prefix itself diverged, the first
        re-executed op fails the backward-chain tripwire again and falls
        through to the sync path — a wrong prefix is never extended."""
        sb = self.superblock
        if (sb is None or sb.op_checkpoint >= first_divergent_op
                or self._rollback_checkpoint == (sb.op_checkpoint,
                                                 self.log_view)):
            return False
        root = self.storage.read(
            "snapshot",
            sb.snapshot_slot * self.storage.layout.snapshot_size_max,
            sb.snapshot_size)
        if checksum(root, domain=b"ckptroot") != sb.snapshot_checksum:
            return False
        self._rollback_checkpoint = (sb.op_checkpoint, self.log_view)
        forest_root, sessions_blob = _split_root(root)
        # Fresh durable engine over the same storage: drops every
        # in-memory LSM/grid structure the divergent suffix built (the
        # copy-on-write grid still holds the checkpoint's blocks; blocks
        # written after it are unreferenced from this root).
        self.durable = DurableState(self.storage)
        self.sessions.restore(sessions_blob)
        self.state_machine = self.state_machine_factory()
        self.state_machine.state = self.durable.open(forest_root,
                                                     load_events=False)
        self.state_machine.attach_durable(self.durable)
        old_commit_min = self.commit_min
        self.commit_min = sb.op_checkpoint
        self.prepare_timestamp = self.state_machine.state.commit_timestamp
        now = self.time.monotonic()
        for op in range(sb.op_checkpoint + 1, first_divergent_op):
            # The stale executed range: replaceable only by prepares that
            # chain down from the canonical suffix.
            self.chain_suspect.add(op)
            self.repair_requested.setdefault(op, 0)
            self._suspect_since.setdefault(op, now)
        self.tracer.count(Event.rollbacks)
        logging.getLogger("tigerbeetle_tpu_torch.vsr").warning(
            "replica %d: divergence at op %d — rolled back to checkpoint "
            "%d (was %d); re-executing the canonical history",
            self.replica_id, first_divergent_op, sb.op_checkpoint,
            old_commit_min)
        return True

    COMMIT_WINDOW_MAX = 8

    def _mirror_quiescent(self) -> bool:
        """The regime in which window commits keep per-op flush content
        identical to single commits (shared predicate: durable.py)."""
        from .durable import mirror_quiescent

        return mirror_quiescent(self.state_machine.raw_state,
                                self.durable.events_persisted)

    def _collect_commit_window(self, head: Message,
                               commit_target: int) -> Optional[list]:
        """Extend the validated head prepare into a contiguous run of
        same-operation create_transfers prepares the state machine may
        execute as ONE device dispatch (commit-window aggregation; the
        reference pipelines 8 prepares, src/config.zig:155). Lookahead
        prepares get the same safety checks the head already passed
        (canonical match, sync floor, quarantine, hash chain); any
        obstacle just ends the run — the head path re-examines it on
        the next loop iteration. Windows never span a checkpoint
        boundary: each op's _post_commit must checkpoint state that
        contains exactly the ops up to it."""
        sm = self.state_machine
        if getattr(sm, "engine", None) != "device" or sm.led is None:
            return None
        # Mirror the ledger's own eligibility gate: in the host-mirror
        # or fixpoint-first regime the window dispatch would be a
        # guaranteed waste (collected, decoded, then refused).
        if sm.led._mirror_route() or sm.led._fixpoint_first:
            return None
        try:
            o = Operation(head.header.operation)
        except ValueError:
            return None
        if (_base_operation(o) != Operation.create_transfers
                or not o.is_multi_batch()):
            return None
        if not self._mirror_quiescent():
            return None
        run = [head]
        prev = head.header.checksum
        interval = self.options.checkpoint_interval
        while len(run) < self.COMMIT_WINDOW_MAX:
            last_op = head.header.op + len(run) - 1
            if last_op % interval == 0:
                break  # a checkpoint fires right after last_op
            nop = last_op + 1
            if nop > commit_target:
                break
            m = self.journal.read_prepare(nop)
            if m is None or m.header.operation != head.header.operation:
                break
            want_hdr = self.canonical.get(nop)
            if want_hdr is not None and m.header.checksum != \
                    want_hdr.checksum:
                break
            if want_hdr is None and nop < self.sync_floor:
                break
            if nop in self.chain_suspect:
                break
            if m.header.parent != prev:
                break
            run.append(m)
            prev = m.header.checksum
        return run if len(run) > 1 else None

    def _commit_op(self, prepare: Message) -> None:
        h = prepare.header
        assert h.op == self.commit_min + 1
        operation = Operation(h.operation)
        with self.tracer.span(Event.commit_execute, ctx=h.trace_ctx,
                              op=h.op, operation=int(operation),
                              window=1):
            result = self.state_machine.commit(operation, prepare.body,
                                               h.timestamp)
        self._post_commit(prepare, result)

    def _post_commit(self, prepare: Message, result: bytes,
                     chunk_count: int = None) -> None:
        """Everything a committed op owes besides state-machine
        execution: AOF, commit_min, durable flush + compaction beat,
        reply recording, checkpoint trigger. chunk_count attributes
        flush chunks to this op in window commits (None = pop all, the
        single-op path)."""
        h = prepare.header
        assert h.op == self.commit_min + 1
        self.tracer.count(Event.commits)
        if self.aof is not None:
            self.aof.append(prepare)
        self.commit_min = h.op
        # Write-through to the LSM forest + one deterministic compaction
        # beat (reference: commit_compact, one beat per op — §3.4).
        # raw_state: the flush consumes device delta columns directly —
        # the mirror drain stays DEFERRED (it runs at read boundaries and
        # checkpoints, amortized), which is most of the serving win.
        with self.tracer.span(Event.commit_compact, op=h.op):
            led = self.state_machine.led
            cols = (led.take_flush_columns(chunk_count)
                    if led is not None else None)
            raw = self.state_machine.raw_state
            if cols and not self._mirror_quiescent():
                # Interleaved history (hard-regime handoff, account
                # creation, expiry): the mirror and the chunks describe
                # overlapping order that only ONE authority may
                # serialize — drain, then flush everything through the
                # object path. Window commits form only in the quiescent
                # regime and execute purely on device, so this must
                # never fire mid-window (a drain here would serialize
                # LATER window ops' chunks into THIS op's flush and
                # break cross-replica physical determinism).
                assert chunk_count is None, \
                    "window commit entered a dirty-mirror regime"
                self.state_machine.state  # drains; chunks become stale
                cols = None
            flushed = self.durable.flush(raw, flush_columns=cols)
            self.state_machine.cache_upsert(*flushed)
            self.durable.compact_beat(h.op)
        if h.client:
            # Reply fields derive from the PREPARE (its view and original
            # primary), never from this replica's identity/current view —
            # replies must be byte-identical across replicas so checkpoints
            # (which carry the session table) are byte-identical and reply
            # slots are peer-repairable (reference: client_replies repair).
            reply_header = Header(
                command=Command.reply, cluster=self.cluster,
                replica=h.replica, view=h.view, op=h.op,
                client=h.client, request=h.request, commit=h.op,
                context=h.checksum, operation=h.operation,
                timestamp=h.timestamp,
                # Derived ONLY from the prepare (like every reply
                # field): the context closes the causal loop at the
                # client without breaking cross-replica byte identity.
                trace_ctx=h.trace_ctx,
            )
            reply = Message(reply_header.finalize(result), body=result)
            evicted = self.sessions.put_reply(h.client, h.request, reply)
            if evicted is not None and self.is_primary:
                ev = Header(
                    command=Command.eviction, cluster=self.cluster,
                    replica=self.replica_id, view=self.view, client=evicted)
                self.bus.send_to_client(evicted, Message(ev.finalize()))
            if self.is_primary:
                self.bus.send_to_client(h.client, reply)
        if self.commit_min % self.options.checkpoint_interval == 0:
            with self.tracer.span(Event.commit_checkpoint,
                                  op=self.commit_min):
                self._checkpoint()

    def _checkpoint(self) -> None:
        """Forest checkpoint + superblock flip (reference
        commit_checkpoint_data / commit_checkpoint_superblock :4989,5110).
        Only manifests + the free set are serialized — table data is already
        durable in the copy-on-write grid, so the flip is incremental."""
        sb = self.superblock
        # WAL durability barrier: every in-flight async append lands
        # before state derived from those prepares is checkpointed.
        # fire=False: a quorum callback firing here could advance
        # commit_min mid-flip (and reenter _checkpoint); the callbacks
        # run at the next tick's poll_io instead.
        self.journal.wait_all(fire=False)
        if constants.VERIFY:
            # Extra-check mode: walk the committed WAL suffix's hash
            # chain (parent linkage across held neighbors).
            prev = None
            for op in range(max(1, self.commit_min - 64),
                            self.commit_min + 1):
                m = self.journal.read_prepare(op)
                if m is None:
                    prev = None
                    continue
                if prev is not None:
                    assert m.header.parent == prev, \
                        f"verify: journal chain break at op {op}"
                prev = m.header.checksum
        sessions_blob = self.sessions.pack()
        ckpt_state = self.state_machine.state  # drains the mirror first
        led = self.state_machine.led
        if led is not None:
            # The drain above made any queued columns stale (the object
            # path now covers everything) — pop them so they cannot leak
            # or trip the column path's quiescent-mirror contract.
            led.take_flush_columns()
        root = (self.durable.checkpoint(ckpt_state)
                + sessions_blob + struct.pack("<I", len(sessions_blob)))
        assert len(root) <= self.storage.layout.snapshot_size_max, \
            "checkpoint root exceeds slot (raise snapshot_size_max)"
        slot = 1 - sb.snapshot_slot
        self.storage.write(
            "snapshot", slot * self.storage.layout.snapshot_size_max, root)
        sb.snapshot_slot = slot
        sb.snapshot_size = len(root)
        sb.snapshot_checksum = checksum(root, domain=b"ckptroot")
        sb.op_checkpoint = self.commit_min
        sb.commit_min = self.commit_min
        sb.commit_max = self.commit_max
        sb.view = self.view
        sb.log_view = self.log_view
        sb.release = self.release
        sb.checkpoint_id = checksum(
            sb.checkpoint_id.to_bytes(16, "little") + root[:64], domain=b"ckpt")
        sb.store(self.storage)
        # Memory-bounds doctrine: everything below the checkpoint is
        # durable in the forest's events tree — prune the host tail at
        # this DETERMINISTIC point (same op on every replica, so states
        # stay byte-identical; restart restores the same base).
        self.state_machine.state.prune_account_events(
            self.durable.events_persisted)

    # ---------------------------------------------------------- view change

    def _start_view_change(self, new_view: int) -> None:
        # Standbys follow, never elect; a rebuilding replica's empty
        # journal must never weigh in a view change either.
        assert not self.is_standby and not self.rebuilding
        assert new_view > self.view
        # One span per attempted view: an escalation (view+1 while still
        # changing) closes the stalled attempt and opens the next.
        self.tracer.end(Event.view_change)
        self.tracer.begin(Event.view_change, view=new_view)
        self._pending_view = None
        self.status = "view_change"
        self.view = new_view
        self.pipeline.clear()
        self.nacks.clear()
        self._dvc_ambiguous.clear()
        self._repair_attempts.clear()
        self._persist_view()
        votes = self.svc_votes.setdefault(new_view, set())
        votes.add(self.replica_id)
        header = Header(
            command=Command.start_view_change, cluster=self.cluster,
            replica=self.replica_id, view=new_view)
        msg = Message(header.finalize())
        for r in range(self.replica_count):
            if r != self.replica_id:
                self.bus.send_to_replica(r, msg)
        self._check_svc_quorum(new_view)

    def on_start_view_change(self, msg: Message) -> None:
        v = msg.header.view
        if self.is_standby or self.rebuilding or v < self.view:
            return
        if v > self.view:
            self._start_view_change(v)
        self.svc_votes.setdefault(v, set()).add(msg.header.replica)
        self._check_svc_quorum(v)

    def _check_svc_quorum(self, v: int) -> None:
        if self.status != "view_change" or v != self.view:
            return
        if len(self.svc_votes.get(v, ())) < self.quorum_view_change:
            return
        self._send_do_view_change(v)

    def _dvc_suffix_headers(self) -> list[Header]:
        """The log suffix as journal-ring HEADERS — including faulty slots
        whose bodies are torn. A torn-but-headered op MUST be advertised:
        omitting it could silently drop a committed op whose only
        surviving quorum-member copy is torn (the new primary resolves
        presence via repair, absence via the nack quorum — reference:
        DVC nack/present bitsets, src/vsr/replica.zig:254)."""
        base = self.superblock.op_checkpoint if self.superblock else 0
        out = []
        for op in range(base + 1, self.op + 1):
            h = self.journal.headers[self.journal.slot_for_op(op)]
            if h is not None and h.op == op and h.command == Command.prepare:
                out.append(h)
        return out

    def _send_do_view_change(self, v: int) -> None:
        """Send our log suffix to the new primary (headers above checkpoint)."""
        body = b"".join(h.pack() for h in self._dvc_suffix_headers())
        header = Header(
            command=Command.do_view_change, cluster=self.cluster,
            replica=self.replica_id, view=v, op=self.op,
            commit=self.commit_min, context=self.log_view)
        msg = Message(header.finalize(body), body=body)
        if self.primary_index(v) == self.replica_id:
            self.on_do_view_change(msg)
        else:
            self.bus.send_to_replica(self.primary_index(v), msg)

    def _suffix_headers(self) -> list[Header]:
        """The log suffix as HEADERS: canonical knowledge FIRST (the
        view-change quorum's truth — our journal may still hold a deposed
        primary's unrepaired prepare under a reused op number), else the
        journal-held header (a new primary knows the chosen log's headers
        before it has repaired the bodies — backups must still learn them,
        or they silently drop the re-replicated old-view prepares)."""
        base = self.superblock.op_checkpoint if self.superblock else 0
        out = []
        for op in range(base + 1, self.op + 1):
            if op in self.canonical:
                out.append(self.canonical[op])
                continue
            m = self.journal.read_prepare(op)
            if m is not None:
                out.append(m.header)
        return out

    def on_do_view_change(self, msg: Message) -> None:
        if self.is_standby or self.rebuilding:
            return
        v = msg.header.view
        if v < self.view or self.primary_index(v) != self.replica_id:
            return
        if v > self.view:
            self._start_view_change(v)
        if self.status != "view_change" or v != self.view:
            return
        self.dvc_messages.setdefault(v, {})[msg.header.replica] = msg
        dvcs = self.dvc_messages[v]
        if self.replica_id not in dvcs:
            body = b"".join(h.pack() for h in self._dvc_suffix_headers())
            own = Header(
                command=Command.do_view_change, cluster=self.cluster,
                replica=self.replica_id, view=v, op=self.op,
                commit=self.commit_min, context=self.log_view)
            dvcs[self.replica_id] = Message(own.finalize(body), body=body)
        if len(dvcs) < self.quorum_view_change:
            return
        # Adopt the best log: max (log_view, op) (VSR view-change rule).
        best = max(dvcs.values(),
                   key=lambda m: (m.header.context, m.header.op))
        # Our own log may extend beyond the chosen one (e.g. a higher
        # log_view with a lower op wins): the excess is uncommitted. Never
        # truncate below commit_min — committed ops are final.
        if self.op > best.header.op:
            self.op = max(best.header.op, self.commit_min)
        # UNION-merge headers across every DVC of the winning log_view:
        # the true log of one log_view is unique, so a peer's copy can
        # fill a hole in the chosen suffix — without this, a tie-broken
        # DVC with a gap would drop the canonical header and the repair
        # prepare would then be rejected as non-canonical (liveness).
        # Same-log_view DVCs CAN conflict at an op: a replica that joined
        # the log_view via start_view may still journal a deposed
        # primary's unrepaired prepare under a reused op number (soak
        # seed 517731180). Resolve by hash-chain walk-down from the tip:
        # the accepted header at op+1 pins op's checksum via its parent;
        # an op with no pinned resolution becomes a HOLE (left out of the
        # canonical set — repair/nack decide it later, and the commit
        # path's chain tripwire guards execution regardless).
        cands: dict[int, list[Header]] = {}
        for m in dvcs.values():
            if m.header.context != best.header.context:
                continue
            for hh in _unpack_headers(m.body):
                if hh.op > best.header.op:
                    continue
                bucket = cands.setdefault(hh.op, [])
                if all(c.checksum != hh.checksum for c in bucket):
                    bucket.append(hh)
        best_headers = []
        expect = None  # checksum pinned by the accepted header above
        prev_op = None
        for op in sorted(cands, reverse=True):
            if prev_op is not None and op != prev_op - 1:
                expect = None  # gap: the chain pin does not carry across
            prev_op = op
            bucket = cands[op]
            if expect is not None:
                chosen = next(
                    (c for c in bucket if c.checksum == expect), None)
            elif len(bucket) == 1:
                chosen = bucket[0]
            else:
                chosen = None  # ambiguous with no pin from above
            if chosen is None:
                if len(bucket) > 1:
                    self._dvc_ambiguous.add(op)
                expect = None
                continue
            best_headers.append(chosen)
            expect = chosen.parent
        best_headers.reverse()
        suffix_base = (min(hh.op for hh in best_headers) if best_headers
                       else best.header.op + 1)
        if suffix_base > self.commit_min + 1:
            # Same unverifiable-base rule as on_start_view, for the new
            # primary itself (the chosen log's sender checkpointed past
            # our position).
            self.sync_floor = max(self.sync_floor, suffix_base)
        self._install_log(best_headers)
        commit_max = max(m.header.commit for m in dvcs.values())
        self.commit_max = max(self.commit_max, commit_max)
        # The view does NOT start yet: the primary must hold the COMPLETE
        # canonical log first (reference: the new primary repairs before
        # start_view; a suffix with holes would strand backups on
        # unverifiable ops). _try_start_view finalizes once repair (already
        # requested by _install_log for mismatches/gaps) completes; if the
        # bodies are unobtainable the view-change timer escalates.
        self._pending_view = v
        self._try_start_view()

    def _try_start_view(self) -> None:
        """Finalize a pending view once the primary's log is complete."""
        if self._pending_view != self.view or self.status != "view_change":
            return
        if self._dvc_ambiguous:
            # Same-log_view fork with no local resolution: finalizing
            # would let this primary's own journal copy masquerade as
            # canonical truth. Stall; the view-change timer escalates to
            # the next view, whose electorate can resolve it.
            return
        for op in range(max(self.commit_min, self.sync_floor - 1) + 1,
                        self.op + 1):
            m = self.journal.read_prepare(op)
            if m is None:
                self.repair_requested.setdefault(op, 0)
                return
            want = self.canonical.get(op)
            if want is not None and m.header.checksum != want.checksum:
                self.repair_requested.setdefault(op, 0)
                return
        v = self._pending_view
        self._pending_view = None
        self.log_view = v
        self.status = "normal"
        self.tracer.end(Event.view_change)
        self._persist_view()
        self._broadcast_start_view()
        self._commit_journal(self.commit_max)
        # Re-replicate the uncommitted canonical suffix in the new view so
        # possibly-committed ops regain a quorum (VSR safety: the view-change
        # quorum intersects every replication quorum).
        for op in range(self.commit_min + 1, self.op + 1):
            m = self.journal.read_prepare(op)
            if m is not None and (
                    op not in self.canonical
                    or self.canonical[op].checksum == m.header.checksum):
                self._primary_adopt_canonical(m)

    def _install_log(self, headers: list) -> None:
        """Install a canonical header suffix; fetch bodies we lack via
        repair. REPLACES the previous canonical set: entries from older
        views are obsolete (the new electorate's log is the only truth),
        and a stale leftover would reject the true prepare forever."""
        self.canonical = {}
        for h in headers:
            self.canonical[h.op] = h
            ours = self.journal.read_prepare(h.op)
            if ours is None or ours.header.checksum != h.checksum:
                self.repair_requested.setdefault(h.op, 0)
        if headers:
            self.op = max(self.op, max(h.op for h in headers))

    def _start_view_message(self) -> Message:
        body = b"".join(h.pack() for h in self._suffix_headers())
        header = Header(
            command=Command.start_view, cluster=self.cluster,
            replica=self.replica_id, view=self.view, op=self.op,
            commit=self.commit_max)
        return Message(header.finalize(body), body=body)

    def _broadcast_start_view(self) -> None:
        msg = self._start_view_message()
        for r in range(self.peer_count):
            if r != self.replica_id:
                self.bus.send_to_replica(r, msg)

    def on_start_view(self, msg: Message) -> None:
        h = msg.header
        if h.view < self.view or h.replica != self.primary_index(h.view):
            return
        if self.rebuilding and not self._rebuild_heard:
            # First contact is the primary itself (no peer checkpoint
            # covers us yet): the goal is its commit_max — reachable
            # through ordinary WAL repair under the canonical suffix.
            self._rebuild_heard = True
            self._rebuild_goal = h.commit
        self.view = h.view
        self.log_view = h.view
        if self.status == "view_change":
            self.tracer.end(Event.view_change)
        self.status = "normal"
        self.pipeline.clear()
        self._persist_view()
        headers = _unpack_headers(msg.body)
        # The suffix covers (primary's checkpoint, primary's op]; an EMPTY
        # suffix means the primary checkpointed at its log end, so the
        # verifiable base is op+1. Anything of ours below the base is
        # UNVERIFIABLE (a deposed primary may have written different
        # prepares under the same op numbers) — never execute it; repair
        # solicits a state-sync offer instead.
        suffix_base = (min(hh.op for hh in headers) if headers
                       else h.op + 1)
        if suffix_base > self.commit_min + 1:
            self.sync_floor = max(self.sync_floor, suffix_base)
        # The electorate's log ends at h.op: anything we hold beyond it is
        # uncommitted by definition — truncate rather than risk executing a
        # deposed primary's prepares under reused op numbers. Never below
        # commit_min: committed ops are final (a raced/stale same-view
        # re-broadcast must not push op under what we executed).
        if self.op > h.op:
            self.op = max(h.op, self.commit_min)
        self._install_log(headers)
        self.commit_max = max(self.commit_max, h.commit)
        self.last_heartbeat_rx = self.time.monotonic()
        self.fault_detector.reset(self.last_heartbeat_rx)
        self._commit_journal(self.commit_max)

    def on_request_start_view(self, msg: Message) -> None:
        if self.is_primary and msg.header.view <= self.view:
            self._broadcast_start_view()

    def _request_start_view(self, view: int) -> None:
        header = Header(
            command=Command.request_start_view, cluster=self.cluster,
            replica=self.replica_id, view=view)
        self.bus.send_to_replica(self.primary_index(view),
                                 Message(header.finalize()))

    def _persist_view(self) -> None:
        if self.superblock is None:
            return
        self.superblock.view = self.view
        self.superblock.log_view = self.log_view
        self.superblock.store(self.storage)

    # -------------------------------------------------------------- repair

    def on_request_prepare(self, msg: Message) -> None:
        if msg.header.context == 1:
            # The requester cannot trust any served prepare for this op (it
            # is below its sync floor): offer our checkpoint — or, when no
            # checkpoint covers it yet, the primary answers with a FULL
            # start_view whose canonical suffix re-verifies the op.
            if (self.superblock is not None
                    and msg.header.op <= self.superblock.op_checkpoint):
                self._send_sync_offer(msg.header.replica)
                return
            if self.is_primary:
                self.bus.send_to_replica(msg.header.replica,
                                         self._start_view_message())
                return
        m = self.journal.read_prepare(msg.header.op)
        wanted = msg.header.parent  # canonical checksum sought (0: unknown)
        if m is not None:
            self.bus.send_to_replica(msg.header.replica, m)
            if wanted != 0 and m.header.checksum != wanted \
                    and not self.rebuilding:
                # We hold a DIFFERENT prepare for this op. A replica
                # prepares at most one body per op, so holding another
                # checksum proves we never prepared the canonical one —
                # the served prepare won't satisfy the repair, but the
                # nack can complete a truncation quorum. (A rebuilding
                # replica lost its promise history with its data file —
                # it can prove nothing and must not nack.)
                self._send_nack(msg.header.replica, msg.header.op, wanted)
        elif (self.superblock is not None
              and msg.header.op <= self.superblock.op_checkpoint):
            # We committed past this op and the WAL wrapped: the peer can
            # never repair forward — offer our checkpoint instead
            # (reference: state sync, docs/internals/sync.md:49-79).
            self._send_sync_offer(msg.header.replica)
        elif msg.header.op > self.commit_min and not self.is_standby \
                and not self.rebuilding:
            # Nothing servable for this op. We may nack only if we can
            # PROVE we never prepared it: the slot must not be a torn
            # write of it (faulty), and the header ring must not hold its
            # header (a held header with an unreadable body means we DID
            # prepare it — reference: the nack eligibility rule,
            # replica.zig:825).
            slot = self.journal.slot_for_op(msg.header.op)
            held_hdr = self.journal.headers[slot]
            prepared_it = (held_hdr is not None
                           and held_hdr.op == msg.header.op
                           and held_hdr.command == Command.prepare)
            if slot not in self.journal.faulty and not prepared_it:
                self._send_nack(msg.header.replica, msg.header.op, wanted)

    def _send_nack(self, dst: int, op: int, wanted: int) -> None:
        header = Header(
            command=Command.nack_prepare, cluster=self.cluster,
            replica=self.replica_id, view=self.view, op=op, parent=wanted)
        self.bus.send_to_replica(dst, Message(header.finalize()))

    def on_nack_prepare(self, msg: Message) -> None:
        """Count nack votes while completing a view change; truncate the
        uncommitted suffix at nack quorum (reference: replica.zig:254
        quorum_nack_prepare + docs/ARCHITECTURE.md:540-563)."""
        h = msg.header
        if (self._pending_view != self.view or self.status != "view_change"
                or h.replica >= self.replica_count
                or h.view != self.view):
            # The view guard is safety-critical: a delayed nack from an
            # earlier view-change round could count toward truncating an
            # op its sender has since acquired (and possibly committed).
            return
        op = h.op
        if op <= max(self.commit_max, self.commit_min) or op > self.op:
            return
        want = self.canonical.get(op)
        if (want.checksum if want is not None else 0) != h.parent:
            return  # nack for a stale/foreign checksum
        votes = self.nacks.setdefault(op, set())
        votes.add(h.replica)
        # Our own journal votes too, under the same eligibility rule.
        held = self.journal.read_prepare(op)
        slot = self.journal.slot_for_op(op)
        held_hdr = self.journal.headers[slot]
        prepared_it = (held_hdr is not None and held_hdr.op == op
                       and held_hdr.command == Command.prepare)
        if held is not None:
            if want is not None and held.header.checksum != want.checksum:
                votes.add(self.replica_id)
        elif slot not in self.journal.faulty and not prepared_it:
            votes.add(self.replica_id)
        if len(votes) < self.quorum_nack:
            return
        # Proven uncommitted: truncate op and the suffix that chains
        # through it, then finalize the view.
        for o in range(op, self.op + 1):
            self.canonical.pop(o, None)
            self.repair_requested.pop(o, None)
            self.chain_suspect.discard(o)
            self.nacks.pop(o, None)
        self.op = op - 1
        self._try_start_view()

    # ---------------------------------------------------------- state sync
    #
    # A replica that fell behind the cluster's WAL coverage jumps to a
    # peer's checkpoint: it receives the checkpoint root blob (`headers`
    # message), fetches every grid block the root reaches
    # (`request_blocks`/`block` — reachability = the root's free-set
    # complement), installs the blocks + root + superblock, and reopens its
    # forest from them. Block integrity is validated transitively on open
    # (every read checks the parent-held checksum), so a corrupted transfer
    # aborts the install and the sync retries.

    def _send_sync_offer(self, dst: int) -> None:
        sb = self.superblock
        root = self.storage.read(
            "snapshot", sb.snapshot_slot * self.storage.layout.snapshot_size_max,
            sb.snapshot_size)
        header = Header(
            command=Command.headers, cluster=self.cluster,
            replica=self.replica_id, view=self.view, op=sb.op_checkpoint,
            commit=self.commit_max, context=sb.checkpoint_id,
            # The release that CHECKPOINTED this root (not our binary's):
            # the receiver must gate on it and stamp it at install.
            release=sb.release)
        self.bus.send_to_replica(dst, Message(header.finalize(root), body=root))

    def on_sync_offer(self, msg: Message) -> None:
        from . import durable as durable_mod

        h = msg.header
        if self.rebuilding and not self._rebuild_heard:
            # Freeze the rebuild goal at first contact: the offering
            # peer's commit_max is a finite catch-up target even under
            # live traffic (the replica keeps following afterwards; the
            # goal only gates when the rebuild may DECLARE completion).
            self._rebuild_heard = True
            self._rebuild_goal = max(h.commit, h.op)
        if h.op <= self.commit_min:
            return  # not ahead of us
        if not self.releases.openable(h.release):
            # A checkpoint from a release this binary can't run (rolling
            # upgrade: we're the lagging binary). Installing it would run
            # new-format data under an old binary — wait for the operator
            # upgrade instead; consensus keeps us in view as a follower.
            return
        if self.syncing is not None and self.syncing["target_op"] >= h.op:
            return  # already syncing to an equal-or-newer target
        try:
            root_forest, _ = _split_root(msg.body)
            manifest_addr, manifest_size = \
                durable_mod.checkpoint_manifest(root_forest)
        except Exception:
            return  # malformed offer
        # A fresh (or retargeted) sync is one phase span, offer→install.
        self.tracer.end(Event.state_sync)
        self.tracer.begin(Event.state_sync, target_op=h.op)
        self.syncing = {
            "target_op": h.op, "root": msg.body, "source": h.replica,
            "commit_max": h.commit, "release": h.release,
            # block index -> full zone-stride bytes (validated)
            "have": {},
            # block index -> (kind, address, size, key_size) to fetch
            "needed": {},
            # manifest chain payloads, head-first (chain fetch is
            # sequential: each block names its successor)
            "manifest_parts": [],
            "last_request": 0,
        }
        # Delta sync: expand the checkpoint's reachability graph from the
        # manifest down, reusing every LOCAL block whose bytes already
        # match its address checksum (copy-on-write checkpoints share most
        # blocks, so a slightly-lagging replica transfers only the delta).
        self._sync_resolve("manifest", manifest_addr, manifest_size, 0)
        self._sync_request_blocks(self.time.monotonic())

    def _sync_resolve(self, kind: str, address, size: int,
                      key_size: int) -> None:
        from .checksum import checksum as _checksum

        sync = self.syncing
        index = address.index
        if index in sync["have"] or index in sync["needed"]:
            return
        block_size = self.storage.layout.grid_block_size
        if size <= block_size and index < self.storage.layout.grid_block_count:
            local = self.storage.read("grid", index * block_size, block_size)
            if _checksum(local[:size], domain=b"blk") == address.checksum:
                sync["have"][index] = local
                self._sync_expand(kind, local[:size], key_size)
                return
        sync["needed"][index] = (kind, address, size, key_size)

    def _sync_expand(self, kind: str, raw: bytes, key_size: int) -> None:
        from ..lsm.forest import chain_next, chain_payload
        from . import durable as durable_mod

        if kind == "manifest":
            sync = self.syncing
            sync["manifest_parts"].append(chain_payload(raw))
            nxt = chain_next(raw)
            if nxt is not None:
                self._sync_resolve("manifest", nxt[0], nxt[1], 0)
            else:
                full = b"".join(sync["manifest_parts"])
                for _name, child_key_size, info in \
                        durable_mod.manifest_children(full):
                    self._sync_resolve("index", info.index_address,
                                       info.index_size, child_key_size)
        elif kind == "index":
            for addr, size in durable_mod.index_children(raw, key_size):
                self._sync_resolve("value", addr, size, key_size)
        # "value": leaf — nothing beneath.

    def _sync_request_blocks(self, now: int) -> None:
        sync = self.syncing
        if sync is None:
            return
        if not sync["needed"]:
            self._sync_install()
            return
        if now - sync["last_request"] < self.options.repair_interval_ns:
            return
        sync["last_request"] = now
        missing = sorted(sync["needed"])[:64]
        body = b"".join(struct.pack("<Q", i) for i in missing)
        header = Header(
            command=Command.request_blocks, cluster=self.cluster,
            replica=self.replica_id, view=self.view, op=sync["target_op"])
        self.bus.send_to_replica(sync["source"],
                                 Message(header.finalize(body), body=body))

    def on_request_blocks(self, msg: Message) -> None:
        block_size = self.storage.layout.grid_block_size
        for off in range(0, len(msg.body), 8):
            (index,) = struct.unpack_from("<Q", msg.body, off)
            if index >= self.storage.layout.grid_block_count:
                continue
            raw = self.storage.read("grid", index * block_size, block_size)
            header = Header(
                command=Command.block, cluster=self.cluster,
                replica=self.replica_id, view=self.view, op=index)
            self.bus.send_to_replica(msg.header.replica,
                                     Message(header.finalize(raw), body=raw))

    def on_block(self, msg: Message) -> None:
        from .checksum import checksum as _checksum

        index = msg.header.op
        sync = self.syncing
        if sync is not None and index in sync["needed"]:
            kind, address, size, key_size = sync["needed"][index]
            # Per-block validation against the parent-held checksum — a
            # corrupt transfer is re-requested, never staged.
            if _checksum(msg.body[:size], domain=b"blk") != address.checksum:
                return
            del sync["needed"][index]
            sync["have"][index] = msg.body
            self._sync_expand(kind, msg.body[:size], key_size)
            if not sync["needed"]:
                self._sync_install()
            return
        # Scrub repair: a peer-provided copy of a corrupt block; install it
        # only if it satisfies the referring structure's checksum.
        fault = self.block_repair.get(index)
        if fault is not None:
            _, address, size = fault
            block_size = self.storage.layout.grid_block_size
            with self.tracer.span(Event.grid_repair_block):
                original = self.storage.read(
                    "grid", index * block_size, block_size)
                self.storage.write("grid", index * block_size, msg.body)
                try:
                    # Validate the repaired MEDIA bytes, not a cache.
                    self.durable.grid.read_block(address, size,
                                                 bypass_cache=True)
                except IOError:
                    self.storage.write(
                        "grid", index * block_size, original)
                    return
                del self.block_repair[index]
                self.scrubber.faults.pop(index, None)

    def _sync_install(self) -> None:
        from .durable import validate_staged_checkpoint

        sync = self.syncing
        block_size = self.storage.layout.grid_block_size
        try:
            # Validate the ENTIRE staged checkpoint before touching the live
            # grid: a bad transfer must not clobber our current (still
            # recoverable) checkpoint.
            root = sync["root"]
            forest_root, sessions_blob = _split_root(root)
            validate_staged_checkpoint(
                sync["have"], self.storage.layout, forest_root)
        except Exception:
            # Corrupted transfer or bad offer: drop and re-request later.
            self.syncing = None
            self.tracer.end(Event.state_sync)
            return
        sb = self.superblock
        # Staged install: persist the sync-progress record BEFORE the
        # first grid write. The incoming blocks may land on indices the
        # current checkpoint still references, so a crash mid-install
        # leaves a grid that belongs to NEITHER checkpoint — the nonzero
        # sync_op makes a normal open refuse the file (rebuild-only),
        # and the final store below clears it in the same flip that
        # adopts the installed checkpoint (atomic via the copy quorum).
        sb.sync_op = sync["target_op"]
        sb.store(self.storage)
        for index, raw in sorted(sync["have"].items()):
            self.storage.write("grid", index * block_size, raw)
        slot = 1 - sb.snapshot_slot
        self.storage.write(
            "snapshot", slot * self.storage.layout.snapshot_size_max, root)
        durable = DurableState(self.storage)
        state = durable.open(forest_root, load_events=False)
        self.sessions.restore(sessions_blob)
        self.durable = durable
        self.durable.grid.on_corrupt = self._note_missing_block
        self.scrubber = GridScrubber(
            self.durable.forest,
            origin_seed=self.replica_id * 2654435761, tracer=self.tracer)
        self.block_repair.clear()
        self.state_machine = self.state_machine_factory()
        self.state_machine.state = state
        self.state_machine.attach_durable(self.durable)
        sb.snapshot_slot = slot
        sb.snapshot_size = len(root)
        sb.snapshot_checksum = checksum(root, domain=b"ckptroot")
        sb.op_checkpoint = sync["target_op"]
        sb.commit_min = sync["target_op"]
        sb.commit_max = max(sb.commit_max, sync["commit_max"])
        # Stamp the release that checkpointed the synced root: a restart
        # must gate on the DATA's release, not on whatever we last wrote
        # (downgrade refusal would otherwise be bypassed for synced state).
        sb.release = sync["release"]
        sb.view = self.view
        sb.log_view = self.log_view
        sb.sync_op = 0  # install complete: clear the staged record
        sb.store(self.storage)
        if self.rebuilding:
            self._rebuild_synced = True
            self._rebuild_certified = False  # re-certify the new grid
        self.commit_min = sync["target_op"]
        self.commit_max = max(self.commit_max, sync["commit_max"])
        self.op = max(self.op, sync["target_op"])
        self.prepare_timestamp = max(
            self.prepare_timestamp,
            self.state_machine.state.commit_timestamp)
        for op in [o for o in self.repair_requested if o <= self.commit_min]:
            del self.repair_requested[op]
        self.syncing = None
        self.tracer.end(Event.state_sync)

    # --------------------------------------------------------- reply repair

    def _request_reply_repair(self, client: int) -> None:
        """Ask peers for the durable reply bytes we lack (reference:
        client_replies repair via request_reply / reply)."""
        entry = self.sessions.get(client)
        if entry is None or entry["reply"] is not None:
            return
        header = Header(
            command=Command.request_reply, cluster=self.cluster,
            replica=self.replica_id, view=self.view, client=client,
            context=entry["reply_checksum"])
        msg = Message(header.finalize())
        for r in range(self.peer_count):
            if r != self.replica_id:
                self.bus.send_to_replica(r, msg)

    def on_request_reply(self, msg: Message) -> None:
        entry = self.sessions.get(msg.header.client)
        if entry is None or entry["reply"] is None:
            return
        if entry["reply_checksum"] != msg.header.context:
            return  # we hold a different (older/newer) reply
        self.bus.send_to_replica(msg.header.replica, entry["reply"])

    def on_reply(self, msg: Message) -> None:
        """A peer answered our request_reply (replicas otherwise never
        receive reply messages)."""
        self.sessions.repair_reply(msg.header.client, msg)

    def _note_missing_block(self, address, size: int) -> None:
        """Grid read-path corruption callback: queue the block for peer
        repair (byte-identical grids make any peer a donor)."""
        self.block_repair[address.index] = ("read", address, size)

    def _repair(self, now: int) -> None:
        if now - self.last_repair_tick < self.options.repair_interval_ns:
            return
        self.last_repair_tick = now
        # Re-derive gaps below commit_max — INCLUDING ops beyond our own
        # log end: they are known-committed, and nothing else pulls them if
        # the original prepares were all lost (no retransmit path exists
        # once the primary's pipeline entry commits). Bounded by the WAL
        # window; older ops resolve via state sync.
        # slot_count - 1: op commit_min+slot_count would share a WAL slot
        # with op commit_min, clobbering the chain anchor the commit-time
        # tripwire validates against.
        repair_hi = min(self.commit_max,
                        self.commit_min + self.storage.layout.slot_count - 1)
        for op in range(self.commit_min + 1, repair_hi + 1):
            if self.journal.read_prepare(op) is None:
                self.repair_requested.setdefault(op, 0)
        for op in [o for o in self.canonical if o <= self.commit_min]:
            del self.canonical[op]
        # Primary: resend the oldest unacked prepare (reference
        # prepare_timeout, replica.zig:3567+ timeout battery).
        if self.is_primary:
            entry = self.pipeline.get(self.commit_min + 1)
            if entry is not None and now - entry.get("sent_at", 0) >= \
                    self.options.repair_interval_ns:
                entry["sent_at"] = now
                for r in range(self.replica_count):
                    if r != self.replica_id and r not in entry["oks"]:
                        self.bus.send_to_replica(r, entry["message"])
        for op, last in list(self.repair_requested.items()):
            held = self.journal.read_prepare(op)
            want_hdr = self.canonical.get(op)
            want = None if want_hdr is None else want_hdr.checksum
            below_floor = want is None and op < self.sync_floor
            # A chain suspicion is moot once the held prepare matches a
            # canonical header (the view-change quorum's truth needs no
            # chain proof) — without this, an already-correct suspect is
            # re-requested forever and starves the repair budget.
            if (op in self.chain_suspect and want is not None
                    and held is not None and held.header.checksum == want):
                self.chain_suspect.discard(op)
            # Forward-chain confirmation: a suspect whose SUCCESSOR is
            # trusted (canonical-matched or unsuspected) and whose
            # successor's parent pins our checksum is the true prepare —
            # this zips a quarantined rollback range down from the
            # canonical suffix one op per pass.
            if op in self.chain_suspect and held is not None:
                nxt = self.journal.read_prepare(op + 1)
                nxt_want = self.canonical.get(op + 1)
                nxt_trusted = nxt is not None and (
                    (nxt_want is not None
                     and nxt.header.checksum == nxt_want.checksum)
                    or (nxt_want is None
                        and (op + 1) not in self.chain_suspect))
                if nxt_trusted and nxt.header.parent == held.header.checksum:
                    # ...but NOT when the committed predecessor contradicts
                    # it: op+1 vouching for op while op-1 (executed)
                    # refuses it is a FORK between our executed prefix and
                    # the forward-chained suffix — without canonical truth
                    # neither side is provably right, so the suspicion
                    # persists and the resend/escalation path (stalled
                    # repair -> request_start_view) resolves it.
                    prev_ok = True
                    if op == self.commit_min + 1:
                        prev_c = self._prepare_checksum(self.commit_min)
                        prev_ok = (not prev_c
                                   or held.header.parent == prev_c)
                    if prev_ok:
                        self.chain_suspect.discard(op)
            satisfied = held is not None and (
                want is None or held.header.checksum == want) and \
                op not in self.chain_suspect and not below_floor
            if op <= self.commit_min or satisfied:
                del self.repair_requested[op]
                if op <= self.commit_min:
                    # Attempts stay sticky for merely-"satisfied" ops: a
                    # fork can ping-pong between forward confirmation and
                    # the backward tripwire (each neighbor vouching
                    # differently), and only an accumulating count ever
                    # reaches the start_view escalation that resolves it.
                    self._repair_attempts.pop(op, None)
                self.chain_suspect.discard(op)
                continue
            if now - last < self.options.repair_interval_ns:
                continue
            if not self.repair_budget.spend(now):
                break  # rate limit: repair must not starve the normal path
            self.repair_requested[op] = now
            attempts = self._repair_attempts.get(op, 0) + 1
            self._repair_attempts[op] = attempts
            if (attempts % 8 == 0 and self.status == "normal"
                    and not self.is_primary and want is None
                    and now - self._rsv_last
                    >= 8 * self.options.repair_interval_ns):
                # Repair is stalling without a canonical anchor: a stale
                # multi-op suffix (a deposed primary's prepares under ops
                # the cluster later committed differently) cannot be
                # replaced one-by-one, because each replacement's
                # hash-chain validation needs a true NEIGHBOR. Re-solicit
                # the CURRENT view's start_view: its canonical suffix pins
                # the checksums (canonical-match acceptance needs no
                # chaining), or — if the suffix base is beyond us — routes
                # to state sync via the sync-floor path.
                self._rsv_last = now
                self._request_start_view(self.view)
            # Below the sync floor a served prepare is untrustworthy —
            # solicit a state-sync offer instead (context=1).
            header = Header(
                command=Command.request_prepare, cluster=self.cluster,
                replica=self.replica_id, view=self.view, op=op,
                context=1 if below_floor else 0,
                parent=want or 0)  # canonical checksum (nack eligibility)
            msg = Message(header.finalize())
            for r in range(self.peer_count):
                if r != self.replica_id:
                    self.bus.send_to_replica(r, msg)
        # Rollback-recovery escalation: a quarantined op whose true
        # prepare no peer journal still holds can never zip down from the
        # canonical suffix — once it lingers past the horizon, fall back
        # to the state-sync path (peers checkpoint eventually, and their
        # checkpoint then covers us).
        horizon = 64 * self.options.repair_interval_ns
        for op, since in list(self._suspect_since.items()):
            if op <= self.commit_min or op not in self.chain_suspect:
                del self._suspect_since[op]
            elif now - since > horizon:
                self.sync_floor = max(self.sync_floor,
                                      max(self.commit_max, op) + 1)
                self.chain_suspect.discard(op)
                del self._suspect_since[op]
        self._try_start_view()  # a pending primary finalizes when complete
        self._sync_request_blocks(now)  # re-request lost sync blocks
        # Scrub repair: ask peers for fresh copies of corrupt blocks. A
        # queued address whose table was compacted away meanwhile is moot —
        # drop it rather than re-request forever.
        for index in [i for i, (_, a, _) in self.block_repair.items()
                      if not self.scrubber.still_referenced(a)]:
            del self.block_repair[index]
        if self.block_repair and self.syncing is None:
            # Batch size follows the budget: one token per 16-block
            # request, bursting up to the available tokens — the
            # post-rebuild certification can queue a whole grid's worth
            # of faults, and draining them one token per tick would
            # stretch the passive window needlessly.
            batches = min(self.repair_budget.available(now),
                          -(-len(self.block_repair) // 16))
            if batches and self.repair_budget.spend(now, batches):
                body = b"".join(
                    struct.pack("<Q", i)
                    for i in sorted(self.block_repair)[:16 * batches])
                header = Header(
                    command=Command.request_blocks, cluster=self.cluster,
                    replica=self.replica_id, view=self.view)
                msg = Message(header.finalize(body), body=body)
                for r in range(self.peer_count):
                    if r != self.replica_id:
                        self.bus.send_to_replica(r, msg)
        # Reply repair: refill missing client replies from peers.
        missing = self.sessions.missing_replies()
        if missing and now - self._reply_repair_last >= \
                4 * self.options.repair_interval_ns:
            self._reply_repair_last = now
            for client in missing[:8]:
                self._request_reply_repair(client)
        self._commit_journal(self.commit_max)

    # ---------------------------------------------------------------- time

    def on_ping(self, msg: Message) -> None:
        # Cluster-config fingerprint enforcement (reference:
        # ConfigCluster must match across the cluster, config.zig:153):
        # a peer built with different journal/message/batch geometry
        # would corrupt shared state — flag it; on_message drops all its
        # replica traffic while flagged. ONLY a MATCHING fingerprint
        # clears the flag: a fingerprint-less ping (legacy, or the
        # message bus's connection-handshake hello) is accepted but must
        # never un-gate a confirmed-mismatched peer, or every reconnect
        # would reopen the gate. The full 64-bit fingerprint rides the
        # ping's otherwise-unused u128 `context`.
        fp = msg.header.context
        if fp != 0 and fp != self._config_fp:
            self.tracer.count(Event.config_mismatch_peer, 1)
            self._config_mismatch.add(msg.header.replica)
            return
        if fp == self._config_fp:
            self._config_mismatch.discard(msg.header.replica)
        elif msg.header.replica in self._config_mismatch:
            return  # absent fingerprint: stay gated, no pong
        if msg.header.release == 0 and msg.header.timestamp == 0:
            # Bus-handshake hello (identification only): observing its
            # zero release would clobber the peer's real one, and the
            # pong echo would feed a degenerate (timestamp=0) clock
            # sample back to the sender.
            return
        self.releases.observe(msg.header.replica, msg.header.release)
        pong = Header(
            command=Command.pong, cluster=self.cluster,
            replica=self.replica_id, view=self.view, release=self.release,
            timestamp=self.time.realtime(), context=msg.header.timestamp)
        self.bus.send_to_replica(msg.header.replica, Message(pong.finalize()))

    def on_pong(self, msg: Message) -> None:
        """Clock sample: context echoes our ping's monotonic tx time
        (reference: clock sampling via ping/pong, src/vsr/clock.zig)."""
        self.releases.observe(msg.header.replica, msg.header.release)
        # Only ACTIVE replicas are clock-quorum sources: a standby's
        # agreeing clock must never let a primary call itself
        # synchronized without a replica quorum (clock.zig samples the
        # replica set only; standbys follow, they don't vouch).
        if msg.header.replica < self.replica_count:
            self.clock.learn(
                msg.header.replica, msg.header.context,
                msg.header.timestamp, self.time.monotonic())

    def tick(self) -> None:
        # Reap async WAL completions first: deferred prepare_oks / the
        # primary's self-acks fire here (sans-io: the engine never calls
        # back into the replica on its own threads).
        self.journal.poll_io()
        now = self.time.monotonic()
        if now - self.last_ping_tx >= self.options.heartbeat_interval_ns * 5:
            self.last_ping_tx = now
            ping = Header(
                command=Command.ping, cluster=self.cluster,
                replica=self.replica_id, view=self.view,
                release=self.release, timestamp=now,
                context=self._config_fp)
            msg = Message(ping.finalize())
            for r in range(self.peer_count):
                if r != self.replica_id:
                    self.bus.send_to_replica(r, msg)
        if self.status == "normal" and self.is_primary:
            if now - self.last_heartbeat_tx >= self.options.heartbeat_interval_ns:
                self.last_heartbeat_tx = now
                header = Header(
                    command=Command.commit, cluster=self.cluster,
                    replica=self.replica_id, view=self.view,
                    commit=self.commit_max)
                msg = Message(header.finalize())
                for r in range(self.peer_count):
                    if r != self.replica_id:
                        self.bus.send_to_replica(r, msg)
            # Self-issued expiry pulse (reference: replica.zig:4906-4910).
            if (not self.pipeline
                    and self.state_machine.pulse_needed(self.prepare_timestamp)):
                self._primary_prepare(Operation.pulse, b"")
        elif self.status == "normal":
            # Commit-progress watchdog (reference: replica_test.zig:479
            # "partition primary-all, send-only"): a primary whose SENDS
            # arrive but who receives nothing keeps heartbeating while
            # commit stalls — heartbeats alone must not renew its lease
            # when this replica holds uncommitted prepares that stopped
            # advancing.
            if (self.commit_max > self._progress_commit
                    or self.view > self._progress_view):
                # Progress, or a fresh view: give the (new) primary a
                # full window before suspecting it — a stale timer firing
                # right after an election would depose the new primary
                # before it can re-replicate the uncommitted suffix.
                self._progress_commit = self.commit_max
                self._progress_view = self.view
                self._progress_ts = now
            elif self.op <= self.commit_max:
                self._progress_ts = now  # nothing outstanding: no stall
            elif (not self.is_standby and not self.rebuilding
                  and now - self._progress_ts
                  >= 2 * self.options.view_change_timeout_ns):
                self._progress_ts = now
                self._start_view_change(self.view + 1)
                return
            # Adaptive liveness: the EWMA fault detector may suspect the
            # primary before the hard timeout (reference fault_detector +
            # timeout battery); the hard timeout stays as the ceiling.
            deadline = min(self.options.view_change_timeout_ns,
                           max(self.fault_detector.deadline_ns(),
                               2 * self.options.heartbeat_interval_ns))
            if now - self.last_heartbeat_rx >= deadline:
                if self.is_standby or self.rebuilding:
                    # Follow the electorate: probe every active replica for
                    # the current view instead of electing (whichever is
                    # primary answers with start_view).
                    self.last_heartbeat_rx = now
                    header = Header(
                        command=Command.request_start_view,
                        cluster=self.cluster, replica=self.replica_id,
                        view=self.view)
                    probe = Message(header.finalize())
                    for r in range(self.replica_count):
                        self.bus.send_to_replica(r, probe)
                else:
                    self._start_view_change(self.view + 1)
        elif self.status == "view_change":
            if now - self.last_heartbeat_rx >= 2 * self.options.view_change_timeout_ns:
                self.last_heartbeat_rx = now
                self._start_view_change(self.view + 1)
        if self.rebuilding:
            self._rebuild_tick(now)
        self._repair(now)
        # Background scrub: a few grid block validations per phase window
        # (reference: grid_scrubber.zig incremental tour); faults queue for
        # peer repair (grids are byte-identical across replicas).
        self._scrub_phase += 1
        if self._scrub_phase % 64 == 0:
            for name, address, size in self.scrubber.tick():
                self.block_repair[address.index] = (name, address, size)


def _split_root(root: bytes) -> tuple[bytes, bytes]:
    """Checkpoint root blob -> (forest root, sessions blob). Layout:
    forest-root || sessions-blob || u32 sessions length."""
    (slen,) = struct.unpack_from("<I", root, len(root) - 4)
    return root[:len(root) - 4 - slen], root[len(root) - 4 - slen:len(root) - 4]


def _reply_fits(operation: Operation, body_len: int,
                message_size_max: int) -> bool:
    """Admission bound: the worst-case reply for `body_len` request bytes
    must fit one message (and so the durable reply slot) — lookups amplify
    16-byte ids into 128-byte records (reference: batch_max accounts for
    both directions, src/state_machine.zig:336-380)."""
    from ..state_machine import OPERATION_SPECS

    spec = OPERATION_SPECS.get(operation)
    if spec is None or spec.event_size == 0 or \
            spec.result_size <= spec.event_size:
        return True
    worst = (body_len // spec.event_size) * spec.result_size
    return HEADER_SIZE + worst + body_len <= message_size_max


def _event_count(operation: Operation, body: bytes) -> int:
    """Number of logical events in a request body (drives timestamp
    assignment: each event gets a distinct timestamp below the prepare's)."""
    from .. import multi_batch
    from ..constants import BATCH_MAX
    from ..state_machine import OPERATION_SPECS

    if operation == Operation.pulse:
        # An expiry pulse may emit up to a full batch of expiry events, each
        # needing a distinct timestamp below the prepare's.
        return BATCH_MAX
    spec = OPERATION_SPECS.get(operation)
    if spec is None or spec.event_size == 0:
        return 1
    if operation.is_multi_batch():
        try:
            batches = multi_batch.decode(body, spec.event_size)
        except ValueError:
            return 1
        return max(1, sum(len(b) // spec.event_size for b in batches))
    return max(1, len(body) // spec.event_size)


def _unpack_headers(body: bytes) -> list[Header]:
    out = []
    for off in range(0, len(body), HEADER_SIZE):
        h = Header.unpack(body[off:off + HEADER_SIZE])
        if h.valid_checksum():
            out.append(h)
    return out
