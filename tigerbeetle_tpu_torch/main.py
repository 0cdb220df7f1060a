"""Process entry point: `python -m tigerbeetle_tpu_torch <command>`.

reference: src/tigerbeetle/main.zig (commands :146-186) + cli.zig. A copy
of the JAX package's `main.py` for these commands:

  format       --cluster=N --replica=I --replica-count=N [--small] <path>
  start        --addresses=a:p,b:p,... --replica=I
               [--engine=device|kernel|oracle] [--platform=cpu] [--small]
               [--trace=PATH] [--statsd=host:port] [--metrics-port=P]
               [--aof=PATH] <path>
  recover      <aof> <path>  |  --from-cluster --addresses=... <path>
  repl         --addresses=... [--cluster=N]
  benchmark    [--transfer-count=N] [--account-count=N] [--zipfian]
               [--platform=cpu]
  inspect      [--small] [--integrity] [--digest] <path>
  amqp         --addresses=... --amqp=host:port
  multiversion [--small] <path>
  fuzz         list | smoke | <name> [seed] [--iterations=N]
               [--platform=cpu]
  devhub       [--record=bench.json] [--history=PATH] [--out=PATH]
               [--cfo-dir=DIR] [--strict]
  cfo          [--kind=mix|fuzz|vopr|chaos] [--seed=S] [--max-runs=N]
               [--budget-s=S] [--traffic=SHAPE] [--failures-file=PATH]
               [--artifact=PATH] [--platform=cpu]
  clients      [--out=DIR]
  version

`start`, `benchmark`, `fuzz` and `cfo` run on the card (CUDA) unless
`--platform cpu` is given, and raise where there is no card. `recover`
replays on the oracle engine, host code, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_addresses(text: str) -> list[tuple[str, int]]:
    out = []
    for part in text.split(","):
        host, _, port = part.rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


def cmd_format(args) -> int:
    from .vsr.replica import Replica
    from .vsr.storage import FileStorage, StorageLayout, TEST_LAYOUT

    layout = TEST_LAYOUT if args.small else StorageLayout()
    storage = FileStorage(args.path, layout=layout, create=True)
    Replica.format(storage, cluster=args.cluster, replica_id=args.replica,
                   replica_count=args.replica_count)
    storage.sync()
    storage.close()
    print(f"formatted {args.path}: cluster={args.cluster} "
          f"replica={args.replica}/{args.replica_count}")
    return 0


class _WallTime:
    def monotonic(self) -> int:
        import time

        return time.monotonic_ns()

    def realtime(self) -> int:
        import time

        return time.time_ns()


def cmd_start(args) -> int:
    # Shutdown rides a signal FLAG from the very top: a SIGINT landing
    # during storage open / warmup / journal recovery must still reach
    # the main loop as an orderly stop (and dump the trace), not die as
    # a KeyboardInterrupt mid-construction. The only remaining unsafe
    # window is the interpreter's own module imports before this line.
    import signal as _signal

    stop: list = []
    prev_int = _signal.signal(_signal.SIGINT, lambda *_: stop.append(1))
    prev_term = _signal.signal(_signal.SIGTERM, lambda *_: stop.append(1))
    from .state_machine import StateMachine
    from .vsr.message_bus import MessageBus
    from .vsr.replica import Replica
    from .vsr.storage import FileStorage, StorageLayout, TEST_LAYOUT

    addresses = _parse_addresses(args.addresses)
    layout = TEST_LAYOUT if args.small else StorageLayout()
    storage = FileStorage(args.path, layout=layout)

    replica_holder: list = []

    def on_message(msg):
        replica_holder[0].on_message(msg)

    # --platform cpu is the CPU's way in; without it the state machine
    # lives on the card, and StateMachine raises where there is none.
    device = args.platform
    tracer = None
    if args.trace or args.statsd or args.metrics_port is not None:
        from .trace import StatsD, Tracer

        statsd = None
        if args.statsd:
            host, sep, port = args.statsd.rpartition(":")
            if not sep or not port.isdigit():
                print(f"error: --statsd expects host:port, got {args.statsd!r}")
                return 2
            statsd = StatsD(host or "127.0.0.1", int(port))
        # pid = replica id: merged cluster traces get one process track
        # per replica (trace/merge.py). --metrics-port implies a
        # recording tracer: the endpoint exposes its registry.
        tracer = Tracer(statsd=statsd, pid=args.replica,
                        emit_interval_s=args.trace_emit_interval)
    bus = MessageBus(cluster=args.cluster, on_message=on_message,
                     replica_addresses=addresses, replica_id=args.replica,
                     listen=True, listen_port=args.listen_port,
                     tracer=tracer)
    aof = None
    if args.aof:
        from .aof import AOF

        aof = AOF(args.aof)
    # Production capacities match the DeviceLedger defaults (the
    # static-allocation bound, reference: config.zig limits); --small
    # keeps test clusters light. Shared by the serving factory AND the
    # warmup so the pre-compiled executables always match serving shapes.
    a_cap = (1 << 12) if args.small else (1 << 17)
    t_cap = (1 << 14) if args.small else (1 << 21)
    replica = Replica(
        cluster=args.cluster, replica_id=args.replica,
        replica_count=len(addresses), storage=storage, bus=bus,
        time=_WallTime(), tracer=tracer, aof=aof,
        state_machine_factory=lambda: StateMachine(
            engine=args.engine, a_cap=a_cap, t_cap=t_cap, device=device))
    replica_holder.append(replica)
    if args.engine == "device":
        # Build the serving kernels and launch them once BEFORE accepting
        # connections: the first nvcc build must not land on a client
        # request's timeout budget.
        from .ops.ledger import warmup_kernels

        warm_s = warmup_kernels(a_cap=a_cap, t_cap=t_cap, device=device)
        print(f"kernels warm in {warm_s:.1f}s", flush=True)
    metrics_server = None
    if args.metrics_port is not None:
        from .metrics import MetricsServer, render_prometheus
        from .trace import burn_rates, evaluate, load_objectives

        try:
            slo_cfg = load_objectives()
        except (OSError, ValueError) as e:
            print(f"warning: SLO objectives unavailable: {e}", flush=True)
            slo_cfg = None

        def _exposition() -> str:
            rows = burn = None
            if slo_cfg is not None:
                rows = evaluate(tracer, slo_cfg["objectives"],
                                emit_to=tracer)
                burn = burn_rates([rows], slo_cfg["burn_window_runs"],
                                  slo_cfg["burn_budget"])
            return render_prometheus(tracer, slo_rows=rows, burn=burn)

        metrics_server = MetricsServer(_exposition,
                                       port=args.metrics_port)
        print(f"metrics on http://127.0.0.1:{metrics_server.port}/metrics",
              flush=True)
    replica.open()
    print(f"replica {args.replica} listening on "
          f"{addresses[args.replica][0]}:{addresses[args.replica][1]} "
          f"(cluster={args.cluster}, engine={args.engine})", flush=True)
    # The reference main loop: tick + io.run_for_ns
    # (src/tigerbeetle/main.zig:522-525). Shutdown rides the signal
    # FLAG installed at the top of cmd_start, not KeyboardInterrupt: a
    # SIGINT delivered while the interpreter is inside a C callback
    # raises there and is swallowed as "exception ignored in callback" —
    # the loop would never see it and the server would ignore the
    # shutdown.
    try:
        last_commit = -1
        while not stop:
            bus.poll(0.01)
            replica.tick()
            if replica.commit_min != last_commit:
                # Progress marker: a supervisor reads these from the
                # replica log to wait for every replica to catch up to
                # the cluster commit level before delivering SIGINT (a
                # lagging backup stopped mid-catch-up would dump a
                # commit-free trace).
                last_commit = replica.commit_min
                print(f"commit={last_commit}", flush=True)
    except KeyboardInterrupt:
        pass  # belt and braces: a late-registered handler race
    finally:
        _signal.signal(_signal.SIGINT, prev_int)
        _signal.signal(_signal.SIGTERM, prev_term)
    if metrics_server is not None:
        metrics_server.close()
    if aof is not None:
        aof.close()
    if tracer is not None:
        tracer.flush_statsd()
        if args.trace:
            tracer.dump_chrome_trace(args.trace)
    return 0


def cmd_repl(args) -> int:
    from .repl import run_repl
    from .vsr.client import Client

    client = Client(cluster=args.cluster, client_id=args.client_id,
                    replica_addresses=_parse_addresses(args.addresses))
    try:
        run_repl(client)
    finally:
        client.close()
    return 0


def cmd_benchmark(args) -> int:
    from .benchmark import bench_config2, bench_config_zipfian

    batches = max(1, args.transfer_count // 8190)
    if args.zipfian:
        accepted, elapsed = bench_config_zipfian(
            batches, account_count=args.account_count, theta=args.theta,
            device=args.platform)
    else:
        accepted, elapsed = bench_config2(
            batches, account_count=args.account_count,
            device=args.platform)
    print(json.dumps({
        "load_accepted_tx_per_s": round(accepted / elapsed, 1),
        "transfers": accepted,
        "seconds": round(elapsed, 3),
    }))
    return 0


def _recover_from_cluster(args) -> int:
    """Rebuild a blank/lost data file from the cluster's live peers
    (reference: src/vsr/replica_reformat.zig): solicit the newest durable
    checkpoint over the state-sync path, install it staged (the
    superblock's sync_op record makes a crash mid-install restart the
    rebuild instead of leaving a half-written file), repair the WAL
    suffix through normal VSR repair, certify the installed grid with a
    full scrub tour, then exit 0 — `start` rejoins as a voter. The
    rebuild commits on the oracle engine (host code), as the JAX
    package's does."""
    import signal as _signal
    import time as _time

    from .state_machine import StateMachine
    from .vsr.message_bus import MessageBus
    from .vsr.replica import Replica
    from .vsr.storage import FileStorage, StorageLayout, TEST_LAYOUT

    if not args.addresses:
        print("error: recover --from-cluster requires --addresses")
        return 2
    addresses = _parse_addresses(args.addresses)
    if args.replica_count != len(addresses):
        print(f"error: --replica-count={args.replica_count} but "
              f"--addresses lists {len(addresses)} replicas")
        return 2
    layout = TEST_LAYOUT if args.small else StorageLayout()
    storage = FileStorage(args.path, layout=layout, create=True)
    holder: list = []
    bus = MessageBus(cluster=args.cluster,
                     on_message=lambda m: holder[0].on_message(m),
                     replica_addresses=addresses, replica_id=args.replica,
                     listen=True, listen_port=args.listen_port)
    replica = Replica(
        cluster=args.cluster, replica_id=args.replica,
        replica_count=args.replica_count, storage=storage, bus=bus,
        time=_WallTime(),
        state_machine_factory=lambda: StateMachine(engine="oracle",
                                                   device="cpu"))
    holder.append(replica)
    replica.open_rebuild()
    print(f"rebuild: replica {args.replica} rebuilding from cluster "
          f"{args.cluster} ({len(addresses) - 1} peers)", flush=True)
    stop: list = []
    prev_int = _signal.signal(_signal.SIGINT, lambda *_: stop.append(1))
    prev_term = _signal.signal(_signal.SIGTERM, lambda *_: stop.append(1))
    t0 = _time.monotonic()
    deadline = t0 + args.timeout_s if args.timeout_s else None
    last_progress, last_print = "", 0.0
    try:
        while not replica.rebuild_complete and not stop:
            bus.poll(0.01)
            replica.tick()
            now = _time.monotonic()
            progress = replica.rebuild_progress()
            if progress != last_progress and now - last_print >= 0.2:
                last_progress, last_print = progress, now
                print(f"rebuild: {progress}", flush=True)
            if deadline is not None and now > deadline:
                print(f"rebuild: TIMED OUT after {args.timeout_s:.0f}s "
                      f"({progress})", flush=True)
                return 1
    finally:
        _signal.signal(_signal.SIGINT, prev_int)
        _signal.signal(_signal.SIGTERM, prev_term)
        bus.close()
        storage.sync()
        storage.close()
    if not replica.rebuild_complete:
        print(f"rebuild: interrupted ({replica.rebuild_progress()}); "
              "re-run recover --from-cluster to resume", flush=True)
        return 1
    replica.finish_rebuild()
    sb = replica.superblock
    print(f"rebuilt {args.path} from cluster: checkpoint op "
          f"{sb.op_checkpoint}, commit {replica.commit_min}, "
          f"{'state-synced' if replica._rebuild_synced else 'WAL-repaired'}"
          f", grid certified, in {_time.monotonic() - t0:.1f}s",
          flush=True)
    return 0


def cmd_recover(args) -> int:
    """Rebuild a fresh data file from an append-only file (reference:
    `tigerbeetle recover` replaying src/aof.zig frames) — or, with
    --from-cluster, from the cluster's live peers over state sync. The
    replay runs on the oracle engine (host code), as the JAX package's
    does."""
    if args.from_cluster:
        if args.path is None:  # only one positional given
            args.path = args.aof
        if args.path is None:
            print("error: recover --from-cluster requires <path>")
            return 2
        return _recover_from_cluster(args)
    if args.aof is None or args.path is None:
        print("error: recover requires <aof> <path> "
              "(or --from-cluster <path>)")
        return 2
    import struct as _struct

    from .aof import recover
    from .state_machine import StateMachine
    from .vsr.checksum import checksum
    from .vsr.client_sessions import ClientSessions
    from .vsr.durable import DurableState
    from .vsr.replica import Replica
    from .vsr.storage import FileStorage, StorageLayout, TEST_LAYOUT
    from .vsr.superblock import SuperBlock

    sm = StateMachine(engine="oracle", device="cpu")
    applied = recover(args.aof, sm)
    layout = TEST_LAYOUT if args.small else StorageLayout()
    storage = FileStorage(args.path, layout=layout, create=True)
    Replica.format(storage, cluster=args.cluster, replica_id=args.replica,
                   replica_count=args.replica_count)
    # Persist the replayed state as a fresh forest checkpoint (the recovered
    # oracle's dirty sets cover every object, so this writes everything).
    # The root carries the sessions trailer like every checkpoint root
    # (empty: AOF replay has no client sessions to preserve).
    durable = DurableState(storage)
    sessions_blob = ClientSessions(storage).pack()
    root = (durable.checkpoint(sm.state)
            + sessions_blob + _struct.pack("<I", len(sessions_blob)))
    storage.write("snapshot", 0, root)
    sb = SuperBlock.load(storage)
    sb.snapshot_slot = 0
    sb.snapshot_size = len(root)
    sb.snapshot_checksum = checksum(root, domain=b"ckptroot")
    sb.store(storage)
    storage.sync()
    storage.close()
    print(f"recovered {applied} ops from {args.aof} into {args.path}")
    return 0


def _open_superblock(args):
    """(storage, superblock) for a path/--small pair, or (storage, None)
    with the shared no-quorum error printed."""
    from .vsr.storage import FileStorage, StorageLayout, TEST_LAYOUT
    from .vsr.superblock import SuperBlock

    layout = TEST_LAYOUT if args.small else StorageLayout()
    storage = FileStorage(args.path, layout=layout)
    sb = SuperBlock.load(storage)
    if sb is None:
        print("superblock: no quorum (unformatted or corrupt)")
    return storage, sb


def cmd_inspect(args) -> int:
    """Render superblock and WAL-slot dumps — against a healthy file OR
    a deliberately corrupted one: every bad checksum is FLAGGED in the
    output, never raised (an inspector that dies on the damage it exists
    to show is useless). Exit 1 when the file is unopenable (no
    superblock quorum / corrupt active checkpoint root)."""
    from .vsr.journal import Journal
    from .vsr.checksum import checksum
    from .vsr.storage import (SUPERBLOCK_COPIES, SUPERBLOCK_COPY_SIZE,
                              FileStorage, StorageLayout, TEST_LAYOUT)
    from .vsr.superblock import SuperBlock

    layout = TEST_LAYOUT if args.small else StorageLayout()
    storage = FileStorage(args.path, layout=layout)
    # Per-copy superblock dump (the quorum rule tolerates torn/corrupt
    # copies — show which ones).
    for copy in range(SUPERBLOCK_COPIES):
        raw = storage.read(
            "superblock", copy * SUPERBLOCK_COPY_SIZE, SUPERBLOCK_COPY_SIZE)
        sb_copy = SuperBlock.unpack_copy(raw)
        if sb_copy is None:
            print(f"superblock copy {copy}: CORRUPT (bad checksum)")
        else:
            print(f"superblock copy {copy}: seq={sb_copy.sequence} "
                  f"view={sb_copy.view} "
                  f"checkpoint_op={sb_copy.op_checkpoint}")
    sb = SuperBlock.load(storage)
    root_ok = False
    if sb is None:
        print("superblock: no quorum (unformatted or corrupt)")
    else:
        print(f"superblock: cluster={sb.cluster} replica={sb.replica_id}/"
              f"{sb.replica_count} seq={sb.sequence} view={sb.view} "
              f"checkpoint_op={sb.op_checkpoint} commit_max={sb.commit_max}")
        if sb.sync_op:
            print(f"superblock: MID-REBUILD — state-sync install to op "
                  f"{sb.sync_op} was interrupted; only `recover "
                  "--from-cluster` may open this file")
        if sb.snapshot_size <= layout.snapshot_size_max:
            root = storage.read(
                "snapshot", sb.snapshot_slot * layout.snapshot_size_max,
                sb.snapshot_size)
            root_ok = checksum(root, domain=b"ckptroot") \
                == sb.snapshot_checksum
        print(f"snapshot: slot={sb.snapshot_slot} size={sb.snapshot_size} "
              f"root={'ok' if root_ok else 'CORRUPT (bad checksum)'}")
    journal = Journal(storage)
    try:
        slots = journal.recover()
    except Exception as e:  # defensive: the dump must outlive bad bytes
        print(f"journal: scan FAILED ({e!r})")
        slots = []
    clean = sum(1 for s in slots if s.state.value == "clean")
    faulty = sum(1 for s in slots if s.state.value == "faulty")
    print(f"journal: {clean} clean, {faulty} faulty, "
          f"{len(slots) - clean - faulty} unknown; op_max={journal.op_max()}")
    # WAL-slot dump: every slot holding a prepare (or failing to).
    for slot, s in enumerate(slots):
        if s.state.value == "clean" and s.header is None:
            continue  # formatted-empty
        if s.header is not None:
            where = f"op={s.header.op} view={s.header.view}"
        else:
            where = "no valid header"
        mark = {"clean": "ok", "faulty": "CORRUPT (bad checksum)",
                "unknown": "CORRUPT (unrecognizable)"}[s.state.value]
        print(f"wal slot {slot:4d}: {where} {mark}")
    if sb is None or not root_ok:
        return 1
    if args.digest:
        return _inspect_digest(storage, sb)
    if args.integrity:
        return _inspect_integrity(storage, sb)
    return 0


def _inspect_digest(storage, sb) -> int:
    """State-epoch digest of the checkpointed forest (ops/state_epoch):
    bit-identical across replicas at the same op_checkpoint, so two
    offline data files can be compared without byte-diffing grids — the
    vortex rebuild scenario's acceptance check."""
    from .ops.state_epoch import combine, oracle_state_digest
    from .vsr.durable import DurableState
    from .vsr.replica import _split_root

    root = storage.read(
        "snapshot", sb.snapshot_slot * storage.layout.snapshot_size_max,
        sb.snapshot_size)
    forest_root, _ = _split_root(root)
    try:
        state = DurableState(storage).open(forest_root, load_events=False)
    except Exception as e:
        print(f"digest: forest open FAILED ({e!r})")
        return 1
    comps = oracle_state_digest(state, a_cap=1 << 12)
    for k in sorted(comps):
        print(f"digest {k}: {comps[k]:016x}")
    print(f"digest: checkpoint_op={sb.op_checkpoint} "
          f"combined={combine(comps):016x}")
    return 0


def _inspect_integrity(storage, sb) -> int:
    """Full-file verification (reference: src/tigerbeetle/inspect_integrity
    .zig): checkpoint root checksum, every grid block reachable from the
    root (manifest -> index -> value, enumerated tolerantly so ALL faults
    are reported, not just the first), the session table's reply slots, and
    a state rebuild from the forest."""
    from .vsr import durable as durable_mod
    from .vsr.checksum import checksum
    from .vsr.client_sessions import ClientSessions
    from .vsr.durable import DurableState
    from .vsr.replica import _split_root

    faults = 0
    root = storage.read(
        "snapshot", sb.snapshot_slot * storage.layout.snapshot_size_max,
        sb.snapshot_size)
    if checksum(root, domain=b"ckptroot") != sb.snapshot_checksum:
        print("integrity: checkpoint root CORRUPT")
        return 1
    forest_root, sessions_blob = _split_root(root)

    # Walk the reachability graph block by block, continuing past faults.
    block_size = storage.layout.grid_block_size

    def read_block(address, size):
        raw = storage.read("grid", address.index * block_size, size)
        if checksum(raw, domain=b"blk") != address.checksum:
            return None
        return raw

    from .lsm.forest import chain_next, chain_payload

    blocks = checked = 0
    link = durable_mod.checkpoint_manifest(forest_root)
    manifest_payload = b""
    while link is not None:
        manifest_addr, manifest_size = link
        blocks += 1
        raw_chain = read_block(manifest_addr, manifest_size)
        if raw_chain is None:
            faults += 1
            print(f"integrity: manifest block {manifest_addr.index} CORRUPT")
            manifest_payload = None
            break
        checked += 1
        manifest_payload += chain_payload(raw_chain)
        link = chain_next(raw_chain)
    if manifest_payload is not None:
        for name, key_size, info in durable_mod.manifest_children(manifest_payload):
            blocks += 1
            index_raw = read_block(info.index_address, info.index_size)
            if index_raw is None:
                faults += 1
                print(f"integrity: grid block {info.index_address.index} "
                      f"({name} index) CORRUPT")
                continue
            checked += 1
            for address, size in durable_mod.index_children(index_raw, key_size):
                blocks += 1
                if read_block(address, size) is None:
                    faults += 1
                    print(f"integrity: grid block {address.index} "
                          f"({name}) CORRUPT")
                else:
                    checked += 1

    durable = DurableState(storage)
    try:
        state = durable.open(forest_root)
    except Exception as e:
        print(f"integrity: forest open FAILED ({e})")
        state = None
        faults += 1
    sessions = ClientSessions(storage)
    sessions.restore(sessions_blob)
    for client in sessions.missing_replies():
        # The slot may legitimately hold a NEWER reply than the checkpoint
        # recorded (post-checkpoint commits rewrite it; WAL replay
        # reconciles on open). Only garbage is a fault.
        from .vsr.header import Message

        entry = sessions.get(client)
        raw = storage.read(
            "client_replies",
            entry["slot"] * storage.layout.message_size_max,
            storage.layout.message_size_max)
        try:
            msg = Message.unpack(raw)
            newer_ok = msg.valid() and msg.header.client == client
        except Exception:
            newer_ok = False
        if not newer_ok:
            faults += 1
            print(f"integrity: reply slot for client {client} CORRUPT")
    state_summary = ("state unreadable" if state is None else
                     f"{len(state.accounts)} accounts, "
                     f"{len(state.transfers)} transfers")
    print(f"integrity: {checked}/{blocks} grid blocks valid, "
          f"{state_summary}, {len(sessions.entries)} sessions, "
          f"{faults} fault(s)")
    return 1 if faults else 0


def cmd_amqp(args) -> int:
    """CDC pump: poll a live cluster's change events, publish to an AMQP
    broker with confirms (reference: `tigerbeetle amqp`, src/cdc/runner.zig)."""
    import time as _time

    from .cdc import AmqpProgress, AmqpSink, CDCRunner, FileProgress
    from .types import ChangeEvent, ChangeEventsFilter, Operation
    from .vsr.client import Client

    client = Client(cluster=args.cluster, client_id=args.client_id,
                    replica_addresses=_parse_addresses(args.addresses))

    class _ClusterSource:
        def get_change_events(self, f: ChangeEventsFilter):
            raw = client.query(Operation.get_change_events, f)
            return [ChangeEvent.unpack(raw[i:i + 384])
                    for i in range(0, len(raw), 384)]

    host, sep, port = args.amqp.rpartition(":")
    if not sep or not port.isdigit() or not host:
        print(f"--amqp must be host:port, got {args.amqp!r}")
        return 1
    amqp_kwargs = dict(user=args.user, password=args.password,
                       virtual_host=args.vhost)
    # Durable progress (reference: the broker-resident progress-tracker
    # queue, src/cdc/runner.zig:34): by default the watermark lives in
    # the broker and a restarted runner resumes exactly after the
    # confirmed stream; --timestamp-last overrides, --progress-file uses
    # a local sidecar instead. Built before the sink so a failed locker
    # declare strands no connection (and vice versa).
    progress_close = None
    if args.progress_file:
        progress = FileProgress(args.progress_file)
    else:
        progress = AmqpProgress(host, int(port), cluster=args.cluster,
                                **amqp_kwargs)
        progress_close = progress.close
    try:
        sink = AmqpSink(host, int(port), exchange=args.exchange,
                        cluster=args.cluster, lock=not args.no_lock,
                        **amqp_kwargs)
    except BaseException:
        if progress_close:
            progress_close()
        raise
    runner = CDCRunner(_ClusterSource(), sink, progress=progress)
    runner.recover()
    if args.timestamp_last:
        # Operator override (reference: recovery_mode .override): seed
        # the watermark AND persist it, so the next restart resumes from
        # the confirmed stream, not from the override again.
        runner.timestamp_processed = args.timestamp_last
        progress.store(args.timestamp_last)
    try:
        while True:
            n = runner.run_until_idle()
            if n:
                print(f"published {n} (total {runner.published}, "
                      f"watermark {runner.timestamp_processed})")
            if args.once:
                return 0
            _time.sleep(args.poll_interval)
    except KeyboardInterrupt:
        return 0
    finally:
        runner.close()
        sink.close()
        if progress_close:
            progress_close()
        client.close()


def cmd_multiversion(args) -> int:
    """Inspect a data file's checkpoint release vs this binary
    (reference: `tigerbeetle multiversion` + the re-exec decision,
    src/multiversion.zig)."""
    from .multiversion import RELEASE, ReleaseTracker, release_str

    _storage, sb = _open_superblock(args)
    if sb is None:
        return 1
    compatible = ReleaseTracker().compatible(sb.release)
    print(f"binary release:     {release_str(RELEASE)}")
    print(f"data file release:  {release_str(sb.release)} "
          f"(checkpoint op {sb.op_checkpoint})")
    print(f"compatible:         {'yes' if compatible else 'NO — upgrade path required'}")
    return 0 if compatible else 1


def cmd_fuzz(args) -> int:
    """Run a named fuzzer with a seed (reference: `zig build fuzz --
    <name> <seed>`, src/fuzz_tests.zig registry)."""
    from .testing import fuzz

    if args.name == "list":
        for name in fuzz.FUZZERS:
            print(name)
        return 0
    if args.name != "smoke" and args.name not in fuzz.FUZZERS:
        print(f"unknown fuzzer {args.name!r}; `fuzz list` shows them")
        return 1
    fuzz.run(args.name, args.seed, args.iterations, device=args.platform)
    print(f"fuzz {args.name} seed={args.seed}: OK")
    return 0


def cmd_devhub(args) -> int:
    """Record bench results + render the metrics dashboard (reference:
    src/scripts/devhub.zig + devhub.tigerbeetle.com)."""
    from . import devhub

    if args.record:
        with open(args.record) as f:
            devhub.record(args.history, json.load(f))
    entries = devhub.load(args.history)
    regress = devhub.regressions(entries)
    n = devhub.render(args.history, args.out, cfo_dir=args.cfo_dir,
                      entries=entries, regress=regress)
    for key, r in regress.items():
        print(f"devhub: REGRESSION {key}: {r['latest']:,.0f} is "
              f"{r['ratio']:.2f}x of trailing median {r['baseline']:,.0f}")
    print(f"devhub: {n} runs -> {args.out}")
    # Nonzero on regression so CI can gate on it (reference: the devhub
    # run IS the nightly perf gate, src/scripts/devhub.zig:174-237).
    return 2 if regress and args.strict else 0


def cmd_cfo(args) -> int:
    """Continuous fuzzing orchestrator: interleave random single-
    component fuzzer runs with WHOLE-CLUSTER VOPR swarm seeds (random
    topology + fault config + audited workload), recording failing
    seeds and a results artifact (reference: src/scripts/cfo.zig —
    fleet machines run fuzzers AND VOPR 24/7, failing seeds pushed to
    devhubdb). Every run's device state lives on `--platform` (default:
    the card); the selection draws are the JAX package's."""
    import random as _random
    import time as _time

    from .testing import fuzz
    from .testing.chaos import TRAFFIC_SHAPES, run_chaos_seed
    from .testing.vopr import run_swarm_seed

    device = args.platform
    on = " --platform cpu" if device == "cpu" else ""
    if args.kind == "chaos" and args.seed is not None and not args.max_runs:
        # `cfo --kind chaos --seed S` IS the documented reproduction
        # command for a failing chaos seed: one run of exactly S.
        args.max_runs = 1
    rng = (_random.Random(args.seed) if args.seed is not None
           else _random.SystemRandom())
    deadline = (_time.monotonic() + args.budget_s) if args.budget_s else None
    names = list(fuzz.FUZZERS)
    counts: dict = {}
    failing: list = []
    t0 = _time.monotonic()
    runs = failures = 0
    try:
        while deadline is None or _time.monotonic() < deadline:
            if args.kind in ("fuzz", "vopr", "chaos"):
                kind = args.kind
            else:
                # Mix: the cluster seeds are the expensive, high-yield
                # side; keep them a steady ~1/3 of the stream, with the
                # serving-chaos seeds a further ~1/6.
                roll = rng.random()
                kind = ("vopr" if roll < (1 / 3)
                        else "chaos" if roll < (1 / 2) else "fuzz")
            seed = (args.seed if args.seed is not None
                    and args.max_runs == 1 else rng.randrange(1 << 30))
            # Chaos traffic shape: explicit --traffic pins it; the
            # random stream interleaves the adversarial shapes with the
            # uniform workload about half the time (seed-deterministic).
            traffic = None
            if kind == "chaos":
                if getattr(args, "traffic", None):
                    traffic = args.traffic
                elif args.seed is None or args.max_runs != 1:
                    traffic = rng.choice((None, None, None)
                                         + TRAFFIC_SHAPES)
            name = kind if kind != "fuzz" else rng.choice(names)
            if kind == "chaos" and traffic:
                name = f"chaos:{traffic}"
            key = f"fuzz:{name}" if kind == "fuzz" else name
            try:
                if kind == "vopr":
                    run_swarm_seed(seed, device=device)
                elif kind == "chaos":
                    run_chaos_seed(seed, traffic=traffic, device=device)
                else:
                    fuzz.run(name, seed, device=device)
                runs += 1
                counts[key] = counts.get(key, 0) + 1
            except Exception as e:  # record and keep hunting
                failures += 1
                # Each record carries ITS OWN exact reproduction command
                # (the fuzzer name cannot be re-derived from the seed).
                repro = (
                    f"python -m tigerbeetle_tpu_torch cfo --kind vopr "
                    f"--seed {seed} --max-runs 1{on}" if kind == "vopr"
                    else f"python -m tigerbeetle_tpu_torch cfo --kind chaos "
                    f"--seed {seed}"
                    + (f" --traffic {traffic}" if traffic else "") + on
                    if kind == "chaos"
                    else f"python -m tigerbeetle_tpu_torch fuzz {name} "
                    f"{seed}{on}")
                failing.append({"kind": kind, "name": name, "seed": seed,
                                "error": repr(e)[:300],
                                "reproduce": repro})
                line = f"{name} {seed} {e!r}"
                print(f"FAIL {line}\n  reproduce: {repro}", flush=True)
                if args.failures_file:
                    with open(args.failures_file, "a") as f:
                        f.write(line + "\n")
            if args.max_runs and runs + failures >= args.max_runs:
                break
    except KeyboardInterrupt:
        pass
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump({
                "runs_clean": runs, "runs_failing": failures,
                "elapsed_s": round(_time.monotonic() - t0, 1),
                "counts": dict(sorted(counts.items())),
                "failing": failing,
            }, f, indent=1)
            f.write("\n")
    print(f"cfo: {runs} clean, {failures} failing "
          f"(reproduce: python -m tigerbeetle_tpu_torch fuzz <name> <seed>"
          f" / cfo --kind vopr --seed <seed> --max-runs 1)")
    return 1 if failures else 0


def cmd_clients(args) -> int:
    """Regenerate the client packages (reference: the per-language
    codegen under src/clients/, run via `zig build clients:*`): the same
    files as the JAX package's `clients`, byte for byte."""
    from .clients import codegen

    written = codegen.write_out(args.out)
    for path in written:
        print(path)
    print(f"clients: {len(written)} files generated into {args.out}/")
    return 0


def cmd_version(args) -> int:
    from . import __version__

    print(f"tigerbeetle-tpu-torch {__version__}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tigerbeetle_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("format")
    p.add_argument("--cluster", type=int, default=0)
    p.add_argument("--replica", type=int, required=True)
    p.add_argument("--replica-count", type=int, required=True)
    p.add_argument("--small", action="store_true",
                   help="small test layout (32-slot WAL)")
    p.add_argument("path")
    p.set_defaults(fn=cmd_format)

    p = sub.add_parser("start")
    p.add_argument("--addresses", required=True)
    p.add_argument("--replica", type=int, required=True)
    p.add_argument("--cluster", type=int, default=0)
    p.add_argument("--engine", choices=("device", "kernel", "oracle"),
                   default="device")
    p.add_argument("--platform", choices=("cuda", "cpu"), default=None,
                   help="where the state machine lives (default: the "
                        "card, CUDA)")
    p.add_argument("--small", action="store_true")
    p.add_argument("--trace", default=None,
                   help="dump a Chrome trace JSON here on shutdown")
    p.add_argument("--statsd", default=None,
                   help="emit DogStatsD metrics to host:port")
    p.add_argument("--trace-emit-interval", type=float, default=10.0,
                   help="seconds between StatsD timing-aggregate flushes "
                        "(gauges reset after each emit)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus text metrics on this HTTP "
                        "port (0 = ephemeral); implies a recording "
                        "tracer")
    p.add_argument("--aof", default=None,
                   help="append committed prepares to this AOF path")
    p.add_argument("--listen-port", type=int, default=None,
                   help="bind this port instead of the advertised one "
                        "(lets a fault proxy sit in front)")
    p.add_argument("path")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("recover")
    p.add_argument("--cluster", type=int, default=0)
    p.add_argument("--replica", type=int, required=True)
    p.add_argument("--replica-count", type=int, required=True)
    p.add_argument("--small", action="store_true")
    p.add_argument("--from-cluster", action="store_true",
                   help="rebuild the data file from live peers over "
                        "state sync instead of an AOF (usage: recover "
                        "--from-cluster --addresses=... <path>)")
    p.add_argument("--addresses", default=None,
                   help="cluster addresses (--from-cluster)")
    p.add_argument("--listen-port", type=int, default=None,
                   help="bind this port instead of the advertised one "
                        "(--from-cluster; lets a fault proxy sit in "
                        "front)")
    p.add_argument("--timeout-s", type=float, default=0,
                   help="--from-cluster: give up after this many "
                        "seconds (0 = wait forever)")
    p.add_argument("aof", nargs="?", default=None)
    p.add_argument("path", nargs="?", default=None)
    p.set_defaults(fn=cmd_recover)

    p = sub.add_parser("repl")
    p.add_argument("--addresses", required=True)
    p.add_argument("--cluster", type=int, default=0)
    p.add_argument("--client-id", type=int, default=1)
    p.set_defaults(fn=cmd_repl)

    p = sub.add_parser("benchmark")
    p.add_argument("--transfer-count", type=int, default=100_000)
    p.add_argument("--account-count", type=int, default=10_000)
    p.add_argument("--zipfian", action="store_true",
                   help="Zipfian hot-account workload (reference default)")
    p.add_argument("--theta", type=float, default=0.99)
    p.add_argument("--platform", choices=("cuda", "cpu"), default=None,
                   help="where the ledger lives (default: the card, CUDA)")
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("inspect")
    p.add_argument("--small", action="store_true")
    p.add_argument("--integrity", action="store_true",
                   help="verify every reachable grid block, reply slot, "
                   "and the state rebuild (exit 1 on any fault)")
    p.add_argument("--digest", action="store_true",
                   help="print the checkpointed forest's state-epoch "
                        "digest (bit-comparable across replicas at the "
                        "same checkpoint)")
    p.add_argument("path")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("amqp")
    p.add_argument("--addresses", required=True)
    p.add_argument("--cluster", type=int, default=0)
    p.add_argument("--client-id", type=int, default=0xCDC)
    p.add_argument("--amqp", required=True, help="broker host:port")
    p.add_argument("--exchange", default="tb.cdc")
    p.add_argument("--user", default="guest")
    p.add_argument("--password", default="guest")
    p.add_argument("--vhost", default="/")
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument("--once", action="store_true",
                   help="one pump pass, then exit")
    p.add_argument("--timestamp-last", type=int, default=0,
                   help="resume after this change-event timestamp")
    p.add_argument("--progress-file", default=None,
                   help="persist/resume the watermark in this file "
                        "(default: a durable queue in the broker)")
    p.add_argument("--no-lock", action="store_true",
                   help="skip the exclusive locker queue (allows "
                        "concurrent runners — duplicates likely)")
    p.set_defaults(fn=cmd_amqp)

    p = sub.add_parser("multiversion")
    p.add_argument("--small", action="store_true")
    p.add_argument("path")
    p.set_defaults(fn=cmd_multiversion)

    p = sub.add_parser("fuzz")
    p.add_argument("name", help="fuzzer name, 'smoke' (all briefly), "
                   "or 'list'")
    p.add_argument("seed", type=int, nargs="?", default=0)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--platform", choices=("cuda", "cpu"), default=None,
                   help="where the fuzzers' device state lives (default: "
                        "the card, CUDA)")
    p.set_defaults(fn=cmd_fuzz)

    p = sub.add_parser("devhub")
    p.add_argument("--record", default=None,
                   help="bench JSON file to append to the history")
    p.add_argument("--history", default="devhub_history.jsonl")
    p.add_argument("--out", default="devhub.html")
    p.add_argument("--cfo-dir", default="cfo",
                   help="directory of CFO sweep artifacts to surface")
    p.add_argument("--strict", action="store_true",
                   help="exit 2 when a metric regressed vs its trailing "
                        "median (the nightly perf gate)")
    p.set_defaults(fn=cmd_devhub)

    p = sub.add_parser("cfo")
    p.add_argument("--budget-s", type=float, default=0,
                   help="stop after this many seconds (0 = run forever)")
    p.add_argument("--max-runs", type=int, default=0)
    p.add_argument("--kind", choices=["mix", "fuzz", "vopr", "chaos"],
                   default="mix",
                   help="mix (default): fuzzer registry + VOPR cluster "
                        "swarm + serving-chaos seeds interleaved; or "
                        "one side only (chaos = seeded device-fault "
                        "injection against the serving supervisor, "
                        "testing/chaos.py)")
    p.add_argument("--failures-file", default=None,
                   help="append failing (fuzzer, seed) pairs here")
    p.add_argument("--artifact", default=None,
                   help="write a JSON results artifact here")
    p.add_argument("--seed", type=int, default=None,
                   help="deterministic selection; with --max-runs 1 the "
                        "seed IS the run seed (reproduction)")
    p.add_argument("--traffic", default=None,
                   choices=["hot_skew", "pending_storm",
                            "open_close_burst"],
                   help="pin a named adversarial traffic shape for "
                        "chaos runs (testing/chaos.py TrafficShape); "
                        "default: the random stream interleaves shapes "
                        "with the uniform workload")
    p.add_argument("--platform", choices=("cuda", "cpu"), default=None,
                   help="where every run's device state lives (default: "
                        "the card, CUDA)")
    p.set_defaults(fn=cmd_cfo)

    p = sub.add_parser("clients")
    p.add_argument("--out", default="clients",
                   help="output root (clients/go, clients/node, ...)")
    p.set_defaults(fn=cmd_clients)

    p = sub.add_parser("version")
    p.set_defaults(fn=cmd_version)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
