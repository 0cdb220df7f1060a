"""Fuzzer registry: seed-replayable randomized checks per subsystem.

reference: src/fuzz_tests.zig:35-57 (the named-fuzzer registry run as
`zig build fuzz -- <name> <seed>`) — here `python -m tigerbeetle_tpu_torch
fuzz <name> <seed>`. Every fuzzer is a pure function of its seed: any
failure reproduces from the command line.

The int generator is bit-edge-biased like the reference's
(src/state_machine_fuzz.zig:17-35): powers of two, off-by-ones, and type
maxes are massively overrepresented because that is where validation code
breaks.

A copy of the JAX package's `testing/fuzz.py`: the same thirteen fuzzers
in the same order, each drawing from its `random.Random` call for call
as there. The fuzzers that build device state take `device` (None: the
card): `state_machine` (the kernel engine, `create_seq`),
`device_ledger` (the device tiers, `ht_probe` and `row_gather`),
`durability` (oracle-engine replicas, whose StateMachine still names a
device) and `storage_faults` / `vopr_smoke` (clusters of kernel-engine
replicas). `run` hands it to those and to no other.
"""

from __future__ import annotations

import random
from typing import Callable




def int_edgy(prng: random.Random, bits: int = 128) -> int:
    """Bit-edge-biased random int in [0, 2^bits)."""
    roll = prng.random()
    if roll < 0.2:
        return prng.randrange(0, 4)
    if roll < 0.4:
        edge = 1 << prng.randrange(0, bits)
        return (edge + prng.choice((-1, 0, 1))) % (1 << bits)
    if roll < 0.5:
        return (1 << bits) - 1 - prng.randrange(0, 4)
    if roll < 0.75:
        return prng.randrange(0, 1 << prng.randrange(1, bits))
    return prng.randrange(0, 1 << bits)


# ------------------------------------------------------------ fuzz targets

def fuzz_ewah(prng: random.Random, iterations: int) -> None:
    """Roundtrip random bitsets incl. long runs (reference: ewah fuzz)."""
    from .. import ewah

    for _ in range(iterations):
        n = prng.randrange(1, 4096)
        style = prng.random()
        if style < 0.4:
            bits = [prng.random() < 0.5 for _ in range(n)]
        elif style < 0.7:
            bits = [False] * n
            for _ in range(prng.randrange(0, 8)):
                bits[prng.randrange(n)] = True
        else:
            run = prng.randrange(1, n + 1)
            bits = ([True] * run + [False] * (n - run))
            prng.shuffle(bits)
        blob = ewah.encode_bitset(bits)
        assert ewah.decode_bitset(blob) == bits


def fuzz_multi_batch(prng: random.Random, iterations: int) -> None:
    """Roundtrip + malformed-trailer rejection (reference: vsr_multi_batch)."""
    from .. import multi_batch

    for _ in range(iterations):
        element_size = prng.choice((1, 2, 8, 16, 64, 128))
        batches = [
            bytes(prng.randrange(256)
                  for _ in range(element_size * prng.randrange(0, 8)))
            for _ in range(prng.randrange(1, 6))]
        body = multi_batch.encode(batches, element_size)
        assert multi_batch.decode(body, element_size) == batches
        # Mutate one byte: must either still decode or raise ValueError —
        # never crash with anything else.
        mutated = bytearray(body)
        mutated[prng.randrange(len(mutated))] ^= 1 << prng.randrange(8)
        try:
            multi_batch.decode(bytes(mutated), element_size)
        except ValueError:
            pass


def fuzz_superblock_quorums(prng: random.Random, iterations: int) -> None:
    """Random torn/corrupt copy patterns must never elect a wrong quorum
    (reference: vsr_superblock_quorums fuzz)."""
    from ..vsr.storage import SUPERBLOCK_COPY_SIZE, TEST_LAYOUT, MemoryStorage
    from ..vsr.superblock import SuperBlock

    for _ in range(iterations):
        storage = MemoryStorage(TEST_LAYOUT)
        sb = SuperBlock(cluster=7, replica_id=0, replica_count=1)
        seqs = []
        for _ in range(prng.randrange(1, 4)):
            sb.commit_max += prng.randrange(0, 5)
            sb.store(storage)
            seqs.append((sb.sequence, sb.commit_max))
        # Corrupt a random subset of copies.
        for copy in range(4):
            if prng.random() < 0.4:
                off = copy * SUPERBLOCK_COPY_SIZE + prng.randrange(64)
                storage.data[off] ^= 0xFF
        got = SuperBlock.load(storage)
        if got is not None:
            assert (got.sequence, got.commit_max) in seqs, \
                "elected a superblock state that was never stored"


def fuzz_journal(prng: random.Random, iterations: int) -> None:
    """Torn writes + bit rot across both WAL rings: recovery must classify
    every slot and never adopt a corrupt prepare (reference: storage fuzz +
    journal recovery decision table)."""
    from ..vsr.header import HEADER_SIZE, Command, Header, Message
    from ..vsr.journal import Journal
    from ..vsr.storage import TEST_LAYOUT, MemoryStorage

    for _ in range(iterations):
        storage = MemoryStorage(TEST_LAYOUT)
        journal = Journal(storage)
        written = {}
        for op in range(1, prng.randrange(2, 12)):
            body = bytes(prng.randrange(256)
                         for _ in range(prng.randrange(0, 64)))
            h = Header(command=Command.prepare, cluster=1, op=op,
                       timestamp=op)
            msg = Message(h.finalize(body), body=body)
            journal.append(msg)
            written[op] = msg.header.checksum
        # Random corruption in either ring.
        zones = TEST_LAYOUT.zone_offsets
        for _ in range(prng.randrange(0, 6)):
            zone = prng.choice(("wal_headers", "wal_prepares"))
            span = (TEST_LAYOUT.slot_count * HEADER_SIZE
                    if zone == "wal_headers"
                    else TEST_LAYOUT.slot_count * TEST_LAYOUT.message_size_max)
            storage.data[zones[zone] + prng.randrange(span)] ^= 0xFF
        fresh = Journal(storage)
        fresh.recover()
        for op, checksum_want in written.items():
            msg = fresh.read_prepare(op)
            if msg is not None:
                assert msg.header.checksum == checksum_want
                assert msg.valid()


def fuzz_lsm_tree(prng: random.Random, iterations: int) -> None:
    """Random put/remove/compaction vs a dict model; scans must agree
    (reference: lsm_tree / lsm_forest fuzzers)."""
    from ..lsm.forest import Forest
    from ..lsm.grid import Grid, MemoryDevice

    for _ in range(iterations):
        grid = Grid(MemoryDevice(8192 * 512), block_size=8192,
                    block_count=512)
        forest = Forest(grid, {"t": (8, 16)})
        tree = forest.trees["t"]
        model: dict[bytes, bytes] = {}
        op_n = 0
        for _ in range(prng.randrange(10, 400)):
            op_n += 1
            key = int_edgy(prng, 20).to_bytes(8, "big")
            if prng.random() < 0.85:
                value = bytes(prng.randrange(256) for _ in range(16))
                tree.put(key, value)
                model[key] = value
            else:
                tree.remove(key)
                model.pop(key, None)
            if prng.random() < 0.2:
                tree.compact_beat(op_n * 32)  # force bar boundaries
            if prng.random() < 0.05:
                root = forest.checkpoint()
                fresh = Forest(grid, {"t": (8, 16)})
                fresh.open(root)
                tree = fresh.trees["t"]
                forest = fresh
        for key, value in model.items():
            assert tree.get(key) == value
        lo, hi = b"\x00" * 8, b"\xff" * 8
        assert dict(tree.scan(lo, hi)) == model


def fuzz_manifest_level(prng: random.Random, iterations: int) -> None:
    """ManifestLevel insert/remove/prune/query interleavings vs a brute-
    force model (reference: the lsm_manifest_level fuzzer,
    src/fuzz_tests.zig + src/lsm/manifest_level.zig). Checks the
    (key range x snapshot range) algebra: visibility at random snapshots,
    lookup candidate sets and their recency order, and prune timing."""
    import dataclasses as _dc

    from ..lsm.manifest_level import SNAPSHOT_LATEST, ManifestLevel

    @_dc.dataclass
    class _FakeInfo:
        key_min: bytes
        key_max: bytes

    @_dc.dataclass
    class _FakeTable:
        info: _FakeInfo
        tag: int = 0  # stable identity (id() reuses addresses after GC)

        @property
        def key_min(self):
            return self.info.key_min

        @property
        def key_max(self):
            return self.info.key_max

    def key(x: int) -> bytes:
        return x.to_bytes(4, "big")

    for it in range(iterations):
        keep_sorted = prng.random() < 0.5  # L1+ vs L0 flavor
        lvl = ManifestLevel(keep_sorted=keep_sorted)
        # Model: list of [table, smin, smax, seq] in insertion order.
        model: list = []
        seq = 0
        op = 1
        for _ in range(prng.randrange(20, 120)):
            op += prng.randrange(1, 4)
            live_model = [m for m in model if m[2] == SNAPSHOT_LATEST]
            roll = prng.random()
            if roll < 0.45 or not live_model:
                lo = prng.randrange(0, 900)
                hi = lo + prng.randrange(1, 80)
                if keep_sorted:
                    # Disjoint-level contract: avoid overlapping the
                    # live set (the tree guarantees this for L1+).
                    busy = [(m[0].info.key_min, m[0].info.key_max)
                            for m in live_model]
                    if any(not (key(hi) < a or key(lo) > b)
                           for a, b in busy):
                        continue
                t = _FakeTable(_FakeInfo(key(lo), key(hi)), tag=seq)
                lvl.insert(t, op)
                model.append([t, op, SNAPSHOT_LATEST, seq])
                seq += 1
            elif roll < 0.75:
                victim = prng.choice(live_model)
                lvl.remove(victim[0], op)
                victim[2] = op
            else:
                oldest = op - prng.randrange(0, 64)
                got = {t.tag for t in lvl.prune(oldest)}
                want = {m[0].tag for m in model
                        if m[2] != SNAPSHOT_LATEST and m[2] <= oldest}
                assert got == want, f"prune mismatch (iter {it})"
                model = [m for m in model if m[0].tag not in want]
            # ---- differential queries at random snapshots
            for snap in (None, op, prng.randrange(1, op + 1)):
                vis = lvl.visible(snap)
                if snap is None:
                    want_ids = [m[0].tag for m in model
                                if m[2] == SNAPSHOT_LATEST]
                else:
                    want_ids = [m[0].tag for m in model
                                if m[1] <= snap < m[2]]
                assert {e.table.tag for e in vis} == set(want_ids), \
                    f"visible mismatch (iter {it}, snap {snap})"
                k = key(prng.randrange(0, 1000))
                got_l = lvl.lookup(k, snap)
                want_l = [m for m in model
                          if (m[2] == SNAPSHOT_LATEST if snap is None
                              else m[1] <= snap < m[2])
                          and m[0].info.key_min <= k <= m[0].info.key_max]
                want_l.sort(key=lambda m: -m[3])  # newest first
                assert [t.tag for t in got_l] == \
                    [m[0].tag for m in want_l], \
                    f"lookup mismatch (iter {it})"


def fuzz_state_machine(prng: random.Random, iterations: int,
                       device=None) -> None:
    """Random op batches with bit-edge ints, kernel vs oracle differential
    (reference: state_machine_fuzz — the poison-pill hunt)."""
    from ..oracle.state_machine import StateMachineOracle
    from ..state_machine import StateMachine
    from ..types import Account, Transfer, TransferFlags

    F = TransferFlags
    flag_pool = [0, int(F.linked), int(F.pending),
                 int(F.post_pending_transfer), int(F.void_pending_transfer),
                 int(F.balancing_debit), int(F.balancing_credit),
                 int(F.closing_debit) | int(F.pending),
                 int(F.pending) | int(F.linked)]
    kernel = StateMachine(engine="kernel", device=device)
    oracle = StateMachineOracle()
    ts = 10**9
    next_id = 1
    for _ in range(iterations):
        ts += 10_000
        if prng.random() < 0.25:
            accounts = []
            for _ in range(prng.randrange(1, 8)):
                accounts.append(Account(
                    id=int_edgy(prng, 8) or next_id, ledger=prng.choice((0, 1, 2)),
                    code=prng.choice((0, 1)),
                    flags=prng.choice((0, 1 << 1, 1 << 2, 1 << 3))))
                next_id += 1
            want = oracle.create_accounts(accounts, ts)
            got = kernel.create_accounts(accounts, ts)
        else:
            transfers = []
            for _ in range(prng.randrange(1, 12)):
                transfers.append(Transfer(
                    id=prng.choice((next_id, int_edgy(prng, 10))),
                    debit_account_id=int_edgy(prng, 4),
                    credit_account_id=int_edgy(prng, 4),
                    amount=int_edgy(prng, 128),
                    pending_id=int_edgy(prng, 10) if prng.random() < 0.4 else 0,
                    timeout=prng.choice((0, 0, 1, 10, 0xFFFFFFFF)),
                    ledger=prng.choice((0, 1, 2)), code=prng.choice((0, 1)),
                    flags=prng.choice(flag_pool)))
                next_id += 1
            want = oracle.create_transfers(transfers, ts)
            got = kernel.create_transfers(transfers, ts)
        assert [(r.timestamp, r.status) for r in got] == \
            [(r.timestamp, r.status) for r in want], "kernel/oracle diverged"


def fuzz_client_sessions(prng: random.Random, iterations: int) -> None:
    """Random put/evict/restore with torn reply slots (reference:
    client_replies faults)."""
    from ..vsr.client_sessions import ClientSessions
    from ..vsr.header import Command, Header, Message
    from ..vsr.storage import TEST_LAYOUT, MemoryStorage

    for _ in range(iterations):
        storage = MemoryStorage(TEST_LAYOUT)
        sessions = ClientSessions(storage)
        model: dict[int, int] = {}
        for _ in range(prng.randrange(1, 40)):
            client = prng.randrange(1, 16)
            request = model.get(client, 0) + 1
            body = bytes(prng.randrange(256)
                         for _ in range(prng.randrange(0, 128)))
            h = Header(command=Command.reply, cluster=1, client=client,
                       request=request)
            evicted = sessions.put_reply(client, request,
                                         Message(h.finalize(body), body=body))
            model[client] = request
            if evicted is not None:
                del model[evicted]
        blob = sessions.pack()
        restored = ClientSessions(storage)
        restored.restore(blob)
        assert {c: e["request"] for c, e in restored.entries.items()} == model
        for e in restored.entries.values():
            assert e["reply"] is not None and e["reply"].valid()


def fuzz_device_ledger(prng: random.Random, iterations: int,
                       device=None) -> None:
    """DeviceLedger vs oracle with mixed-eligibility batches: hard flags
    (balancing, closing), two-phase, chains, and hot accounts force
    transitions between the vectorized fast path and the host-mirror
    regime; results AND full state (including history rows) must match
    event for event."""
    from ..ops.ledger import DeviceLedger
    from ..oracle.state_machine import StateMachineOracle
    from ..types import Account, AccountFlags, Transfer, TransferFlags

    F = TransferFlags
    led = DeviceLedger(a_cap=1 << 8, t_cap=1 << 12, device=device)
    sm = StateMachineOracle()
    n_accounts = 12
    accounts = [
        Account(id=i, ledger=1, code=1,
                flags=int(AccountFlags.debits_must_not_exceed_credits)
                if i % 4 == 0 else 0)
        for i in range(1, n_accounts + 1)]
    for engine in (led, sm):
        engine.create_accounts(accounts, 1000)
    from ..constants import NS_PER_S

    ts = 10**9
    next_id = 100
    open_pendings: list[int] = []
    for _ in range(iterations):
        # Mostly small steps; occasionally jump whole seconds so 1-2s
        # pending timeouts actually elapse (exercising expiry + the
        # closed-account reopen paths).
        ts += prng.choice((10_000, 10_000, 10_000, 2 * NS_PER_S))
        events = []
        for _ in range(prng.randrange(1, 10)):
            tid = next_id
            next_id += 1
            roll = prng.random()
            dr = prng.randrange(1, n_accounts + 1)
            cr = prng.randrange(1, n_accounts + 1)
            if cr == dr:
                cr = dr % n_accounts + 1
            if roll < 0.5:
                flags = 0
                timeout = 0
                if prng.random() < 0.3:
                    flags = int(F.pending)
                    timeout = prng.choice((0, 1, 2))
                    open_pendings.append(tid)
                if prng.random() < 0.15:
                    flags |= int(F.linked)
                events.append(Transfer(
                    id=tid, debit_account_id=dr, credit_account_id=cr,
                    amount=int_edgy(prng, 16), ledger=1, code=1,
                    flags=flags, timeout=timeout))
            elif roll < 0.65 and open_pendings:
                pid = open_pendings.pop(prng.randrange(len(open_pendings)))
                post = prng.random() < 0.6
                events.append(Transfer(
                    id=tid, pending_id=pid,
                    amount=(1 << 128) - 1 if post else 0,
                    flags=int(F.post_pending_transfer if post
                              else F.void_pending_transfer)))
            elif roll < 0.8:
                events.append(Transfer(  # hard: balancing clamp
                    id=tid, debit_account_id=dr, credit_account_id=cr,
                    amount=int_edgy(prng, 12), ledger=1, code=1,
                    flags=int(F.balancing_debit)))
            else:
                events.append(Transfer(  # hard: closing pending
                    id=tid, debit_account_id=dr, credit_account_id=cr,
                    amount=prng.randrange(0, 10), ledger=1, code=1,
                    timeout=prng.choice((0, 1)),
                    flags=int(F.pending | F.closing_debit)))
                # Voiding (or expiry) reopens the account — track it so
                # accounts don't stay closed for the whole run.
                open_pendings.append(tid)
        got = led.create_transfers(events, ts)
        want = sm.create_transfers(events, ts)
        assert [(r.timestamp, r.status) for r in got] == \
            [(r.timestamp, r.status) for r in want], "ledger/oracle diverged"
        if prng.random() < 0.2:
            ts += prng.choice((10_000, 3 * NS_PER_S))
            assert led.expire_pending_transfers(ts) == \
                sm.expire_pending_transfers(ts)
    host = led.to_host()
    for field in ("accounts", "transfers", "pending_status", "orphaned",
                  "expiry", "account_events"):
        assert getattr(host, field) == getattr(sm, field), field


class _CrashPoint(Exception):
    pass


class _CrashingStorage:
    """MemoryStorage proxy that crashes after N writes, usually TEARING
    the final write (a random prefix lands; the rest is lost) — the
    crash-consistency injector (reference: testing/storage.zig fault
    rules + the storage fuzzer's crash-consistency hunt)."""

    def __init__(self, inner, crash_after: int, prng):
        self.inner = inner
        self.layout = inner.layout
        self.writes_left = crash_after
        self.prng = prng

    def read(self, zone, offset, size):
        return self.inner.read(zone, offset, size)

    def write(self, zone, offset, data):
        if self.writes_left <= 0:
            if data and self.prng.random() < 0.75:
                torn = self.prng.randrange(0, len(data))
                self.inner.write(zone, offset, data[:torn])
            raise _CrashPoint()
        self.writes_left -= 1
        self.inner.write(zone, offset, data)

    def sync(self):
        self.inner.sync()

    # Async surface: decline, so the journal takes its synchronous path —
    # every write then flows through the crash counter above.
    def write_pair_async(self, *args):
        return None

    def io_poll(self):
        return []

    def read_batch(self, zone, reqs):
        # Through self.read so every extent flows through the injector.
        return [self.read(zone, off, size) for off, size in reqs]


def fuzz_durability(prng: random.Random, iterations: int,
                    device=None) -> None:
    """Crash at a random WRITE boundary while a replica commits and
    checkpoints, then reopen the surviving bytes: recovery must never
    crash, must land exactly on checkpoint + contiguous WAL replay, and
    the books must balance (reference: the VOPR storage checker's
    crash-consistency guarantees, docs/internals/data_file.md:63-94)."""
    from ..state_machine import StateMachine
    from ..types import Account, Operation, Transfer
    from ..vsr.replica import Replica
    from ..vsr.storage import TEST_LAYOUT, MemoryStorage

    class _Bus:
        def send_to_replica(self, dst, msg):
            pass

        def send_to_client(self, client, msg):
            pass

    class _Time:
        now = 1_700_000_000 * 10**9

        def monotonic(self):
            self.now += 1_000_000
            return self.now

        def realtime(self):
            return self.now

    def make_replica(storage):
        replica = Replica(
            cluster=1, replica_id=0, replica_count=1, storage=storage,
            bus=_Bus(), time=_Time(),
            state_machine_factory=lambda: StateMachine(engine="oracle",
                                                       device=device))
        replica.open()
        return replica

    for _ in range(iterations):
        base = MemoryStorage(TEST_LAYOUT)
        Replica.format(base, cluster=1, replica_id=0, replica_count=1)
        crash_after = prng.randrange(1, 400)
        storage = _CrashingStorage(base, crash_after, prng)
        # Ops committed strictly BEFORE the in-flight call at crash time
        # are fully in the WAL: recovery MUST replay at least this far.
        durable_floor = 0
        try:
            replica = make_replica(storage)
            tid = 100
            for op_i in range(prng.randrange(5, 40)):
                durable_floor = replica.commit_min
                if op_i == 0:
                    body_objs = [Account(id=i, ledger=1, code=1)
                                 for i in (1, 2)]
                    replica._primary_prepare(
                        Operation.create_accounts,
                        _encode_batch([o.pack() for o in body_objs]))
                else:
                    t = Transfer(id=tid, debit_account_id=1,
                                 credit_account_id=2,
                                 amount=prng.randrange(1, 100),
                                 ledger=1, code=1)
                    tid += 1
                    replica._primary_prepare(
                        Operation.create_transfers,
                        _encode_batch([t.pack()]))
            durable_floor = replica.commit_min  # no crash: all durable
        except _CrashPoint:
            pass

        # Recovery on the surviving bytes must always succeed...
        recovered = make_replica(base)
        state = recovered.state_machine.state
        # ...journal replay reaches every op fully written before the
        # crash (losing a committed op = data loss)...
        assert recovered.commit_min >= durable_floor, \
            (recovered.commit_min, durable_floor)
        # ...and the books balance exactly.
        debits = sum(a.debits_posted for a in state.accounts.values())
        credits = sum(a.credits_posted for a in state.accounts.values())
        assert debits == credits
        assert debits == sum(t.amount for t in state.transfers.values())


def _encode_batch(payloads: list) -> bytes:
    from .. import multi_batch

    return multi_batch.encode([b"".join(payloads)], 128)


def fuzz_message_bus(prng: random.Random, iterations: int) -> None:
    """Frame truncation/corruption/reorder/garbage against the TCP bus's
    weak delivery contract (reference: message_buffer.zig framing): for
    ANY byte stream, every delivered message must be a valid frame that
    was actually sent (drop / duplicate / reorder are allowed; delivering
    corruption never is) and the event loop must survive.

    Trace-context frames: some frames carry a trace-context
    block in the header's reserved (out-of-checksum) region. Targeted
    corruption INSIDE that block must degrade the context to dropped/
    unsampled — the frame still delivers, the payload is untouched, and
    the bus never crashes; an intact block must survive delivery
    byte-identically."""
    import selectors as _selectors
    import socket as _socket

    from ..trace.context import CTX_WIRE_SIZE, mint_context
    from ..vsr import message_bus as mb
    from ..vsr.header import TRACE_CTX_OFFSET, Command, Header, Message

    for _ in range(iterations):
        got: list = []
        bus = mb.MessageBus(cluster=7, on_message=got.append,
                            replica_addresses=[("127.0.0.1", 1)])
        a, b = _socket.socketpair()
        b.setblocking(False)
        conn = mb._Connection(b)
        bus.connections[b] = conn
        bus.selector.register(b, _selectors.EVENT_READ, conn)
        frames = []
        ctx_want: dict = {}  # header checksum -> expected TraceContext
        for i in range(prng.randrange(1, 12)):
            body = bytes(prng.randrange(256)
                         for _ in range(prng.randrange(0, 200)))
            ctx = (mint_context(i + 1, i + 1, seed=7)
                   if prng.random() < 0.5 else None)
            h = Header(command=prng.choice(
                (Command.ping, Command.commit, Command.prepare_ok)),
                cluster=7, replica=prng.randrange(3), op=i,
                trace_ctx=ctx)
            msg = Message(h.finalize(body), body=body)
            raw = bytearray(msg.pack())
            if ctx is not None and prng.random() < 0.5:
                # Flip one bit inside the trace-context block: the block
                # is outside the header checksum, so the frame stays
                # valid and MUST still deliver — with the context
                # dropped (unpack's magic/mini-checksum rejects any
                # single-bit damage), never a crash or a payload change.
                off = TRACE_CTX_OFFSET + prng.randrange(CTX_WIRE_SIZE)
                raw[off] ^= 1 << prng.randrange(8)
                ctx = None
            ctx_want[msg.header.checksum] = ctx
            frames.append(bytes(raw))
        sent = set(ctx_want)
        order = list(frames)
        if prng.random() < 0.5:
            prng.shuffle(order)  # reorder: allowed by the contract
        if prng.random() < 0.3:
            order.append(prng.choice(order))  # duplicate: allowed too
        stream = bytearray(b"".join(order))
        roll = prng.random()
        if roll < 0.4:
            # single-bit corruption anywhere (header or body checksum
            # must catch it: skip-frame for a bad body, connection close
            # for a bad header)
            stream[prng.randrange(len(stream))] ^= 1 << prng.randrange(8)
        elif roll < 0.6:
            del stream[prng.randrange(len(stream)):]  # truncate the tail
        elif roll < 0.75:
            # garbage spliced mid-stream: the bus must close the
            # connection rather than deliver anything derived from it
            cut = prng.randrange(len(stream) + 1)
            junk = bytes(prng.randrange(256)
                         for _ in range(prng.randrange(1, 64)))
            stream = stream[:cut] + junk + stream[cut:]
        try:
            a.sendall(bytes(stream))
        except OSError:
            pass
        a.close()
        for _ in range(64):
            bus.poll(0)
            if b not in bus.connections:
                break
        for m in got:
            assert m.valid()
            assert m.header.checksum in sent, \
                "bus delivered a frame that was never sent"
            if roll >= 0.4:
                # Stream undamaged by the generic corruption modes: a
                # delivered frame's context must match what was sent —
                # intact contexts byte-identical, ctx-corrupted ones
                # dropped to None (unsampled) with the payload intact.
                assert m.header.trace_ctx == \
                    ctx_want[m.header.checksum], \
                    "trace context did not degrade cleanly"
        bus.close()


def fuzz_storage_faults(prng: random.Random, iterations: int,
                        device=None) -> None:
    """Zone-fault rules (reference: src/testing/storage.zig fault spec):
    inject only faults the design tolerates — <= 2 of 4 superblock
    copies, WAL slots in either ring (peer-repairable), the INACTIVE
    snapshot slot, reachable grid blocks (scrub + peer repair) — plus
    faults during the rebuild-from-cluster window (decay of freshly
    installed blocks before certification, crashes between rebuild
    phases). Recovery must then converge with zero silent divergence
    (settle() asserts byte-identical checkpoints)."""
    from .. import multi_batch
    from ..state_machine import StateMachine
    from ..types import Account, Operation, Transfer
    from ..vsr.grid_scrubber import GridScrubber
    from ..vsr.header import HEADER_SIZE
    from ..vsr.storage import SUPERBLOCK_COPY_SIZE, TEST_LAYOUT
    from ..vsr.superblock import SuperBlock
    from .cluster import Cluster

    def transfers_body(specs):
        payload = b"".join(
            Transfer(id=i, debit_account_id=1, credit_account_id=2,
                     amount=amt, ledger=1, code=1).pack()
            for (i, amt) in specs)
        return multi_batch.encode([payload], 128)

    zones = TEST_LAYOUT.zone_offsets
    bs = TEST_LAYOUT.grid_block_size

    def reachable_blocks(replica):
        # (index, logical size): flips must land inside the checksummed
        # region — padding beyond `size` is never read back, so rot
        # there is (by design) invisible and unrepaired.
        return sorted({(a.index, size)
                       for _, a, size in replica.scrubber._blocks()})

    for _ in range(iterations):
        cluster = Cluster(
            seed=prng.randrange(1 << 30), replica_count=3,
            state_machine_factory=lambda: StateMachine(device=device))
        client = cluster.client(5)

        def drive(op, body):
            client.request(op, body)
            assert cluster.run(4000, until=lambda: client.idle), \
                cluster.debug_status()

        drive(Operation.create_accounts, multi_batch.encode(
            [b"".join(Account(id=i, ledger=1, code=1).pack()
                      for i in (1, 2))], 128))
        for k in range(prng.randrange(18, 40)):
            drive(Operation.create_transfers,
                  transfers_body([(100 + k, 1)]))
        victim = prng.randrange(3)
        st = cluster.storages[victim]
        mode = prng.choice(("restart", "scrub", "rebuild"))
        if mode == "restart":
            cluster.crash(victim)
            # Superblock: at most copies - read_quorum corrupt copies.
            for copy in prng.sample(range(4), prng.randrange(0, 3)):
                st.data[zones["superblock"]
                        + copy * SUPERBLOCK_COPY_SIZE
                        + prng.randrange(64)] ^= 0xFF
            # WAL: random bytes in either ring (repair refills them).
            for _ in range(prng.randrange(0, 6)):
                ring = prng.choice(("wal_headers", "wal_prepares"))
                span = (TEST_LAYOUT.slot_count * HEADER_SIZE
                        if ring == "wal_headers"
                        else TEST_LAYOUT.slot_count
                        * TEST_LAYOUT.message_size_max)
                st.data[zones[ring] + prng.randrange(span)] ^= 0xFF
            # Snapshot: only the INACTIVE slot — losing the active root
            # means total data loss, which is the rebuild mode below.
            sb = SuperBlock.load(st)
            if sb is not None:
                off = zones["snapshot"] + (1 - sb.snapshot_slot) \
                    * TEST_LAYOUT.snapshot_size_max
                st.data[off + prng.randrange(
                    TEST_LAYOUT.snapshot_size_max)] ^= 0xFF
            cluster.restart(victim)
            cluster.settle(8000)
        elif mode == "scrub":
            # Live grid decay: the scrubber must surface it and peer
            # repair must restore the exact bytes.
            replica = cluster.replicas[victim]
            replica.scrubber = GridScrubber(
                replica.durable.forest, cycle_ticks=8, origin_seed=victim)
            blocks = reachable_blocks(replica)
            for block, size in prng.sample(blocks,
                                           min(len(blocks),
                                               prng.randrange(1, 4))):
                st.data[zones["grid"] + block * bs
                        + prng.randrange(size)] ^= 0xFF
            ok = cluster.run(8000, until=lambda: (
                replica.scrubber.cycles >= 1
                and not replica.scrubber.faults
                and not replica.block_repair))
            assert ok, "scrub repair did not converge"
            cluster.settle()
        else:  # the rebuild window
            cluster.destroy_data_file(victim)
            for k in range(prng.randrange(2, 8)):
                drive(Operation.create_transfers,
                      transfers_body([(400 + k, 1)]))
            replica = cluster.begin_rebuild(victim)
            if prng.random() < 0.4:
                # Crash between rebuild phases: throw the half-rebuilt
                # replica away and start over — must still converge.
                cluster.run(prng.randrange(10, 200))
                cluster.crash(victim)
                replica = cluster.begin_rebuild(victim)
            ok = cluster.run(16000, until=lambda: (
                replica._rebuild_synced or replica.rebuild_complete))
            assert ok, replica.rebuild_progress()
            if replica._rebuild_synced and not replica._rebuild_certified:
                # Decay during the rebuild window: a freshly installed
                # block rots before certification — the certify tour
                # must catch it and route it through peer repair.
                blocks = reachable_blocks(replica)
                if blocks:
                    block, size = prng.choice(blocks)
                    st.data[zones["grid"] + block * bs
                            + prng.randrange(size)] ^= 0xFF
            ok = cluster.run(16000,
                             until=lambda: replica.rebuild_complete)
            assert ok, replica.rebuild_progress() + " | " \
                + cluster.debug_status()
            replica.finish_rebuild()
            cluster.settle()


def fuzz_vopr_smoke(prng: random.Random, iterations: int,
                    device=None) -> None:
    """One short randomized cluster run per iteration (the full VOPR swarm
    lives in tests/test_vopr.py; this is the registry's smoke entry)."""
    from .. import multi_batch
    from ..state_machine import StateMachine
    from ..types import Account, Operation
    from .cluster import Cluster, NetworkOptions

    MSN = 1_000_000
    for _ in range(iterations):
        cluster = Cluster(
            seed=prng.randrange(1 << 30), replica_count=prng.choice((2, 3)),
            network=NetworkOptions(
                loss_probability=prng.choice((0.0, 0.05)),
                duplicate_probability=prng.choice((0.0, 0.05)),
                delay_min_ns=1 * MSN, delay_max_ns=20 * MSN),
            state_machine_factory=lambda: StateMachine(device=device))
        client = cluster.client(1)
        client.request(Operation.create_accounts, multi_batch.encode(
            [b"".join(Account(id=i, ledger=1, code=1).pack()
                      for i in (1, 2))], 128))
        assert cluster.run(6000, until=lambda: client.idle), \
            cluster.debug_status()
        cluster.settle()


FUZZERS: dict[str, Callable[[random.Random, int], None]] = {
    "ewah": fuzz_ewah,
    "multi_batch": fuzz_multi_batch,
    "superblock_quorums": fuzz_superblock_quorums,
    "journal": fuzz_journal,
    "lsm_tree": fuzz_lsm_tree,
    "lsm_manifest_level": fuzz_manifest_level,
    "state_machine": fuzz_state_machine,
    "client_sessions": fuzz_client_sessions,
    "device_ledger": fuzz_device_ledger,
    "durability": fuzz_durability,
    "message_bus": fuzz_message_bus,
    "storage_faults": fuzz_storage_faults,
    "vopr_smoke": fuzz_vopr_smoke,
}

# The fuzzers that build device state, and so take `device`.
DEVICE_FUZZERS = frozenset({"state_machine", "device_ledger", "durability",
                            "storage_faults", "vopr_smoke"})

DEFAULT_ITERATIONS = {
    "ewah": 200,
    "multi_batch": 300,
    "superblock_quorums": 150,
    "journal": 60,
    "lsm_tree": 10,
    "lsm_manifest_level": 40,
    "state_machine": 60,
    "client_sessions": 80,
    "device_ledger": 30,
    "durability": 12,
    "message_bus": 60,
    "storage_faults": 3,
    "vopr_smoke": 2,
}


def run(name: str, seed: int, iterations: int | None = None,
        device=None) -> None:
    """Run one fuzzer (or 'smoke' = every fuzzer briefly). Fuzzers always
    run with the extra-check mode on (reference: fuzz builds compile
    constants.verify in, src/fuzz_tests.zig:11-16). `device` (None: the
    card) goes to the fuzzers of DEVICE_FUZZERS."""
    from .. import constants

    if name == "smoke":
        for sub in FUZZERS:
            run(sub, seed,
                iterations if iterations is not None
                else max(1, DEFAULT_ITERATIONS[sub] // 10), device=device)
        return
    fuzzer = FUZZERS[name]
    kwargs = {"device": device} if name in DEVICE_FUZZERS else {}
    was = constants.VERIFY
    constants.set_verify(True)
    try:
        fuzzer(random.Random(seed),
               iterations if iterations is not None
               else DEFAULT_ITERATIONS[name], **kwargs)
    finally:
        constants.set_verify(was)
