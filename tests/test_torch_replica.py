"""The port's `Replica` against the JAX package's, one of each fed the same
messages under one fake time source.

Every message each replica sends (replies, prepare_oks, pings) must be
byte-equal, and so must every storage zone at each checkpoint: on the
oracle engine and on the device engine at small capacities, through a
crash and `open` with WAL replay, a duplicate request answered from the
session, a backup committing windows of prepares from a native-engine
data file (its asynchronous WAL acks deferred to the next tick), and a
data file the JAX replica wrote, opened and carried on by the port's.
"""

import random
import shutil
import time as _clock

import pytest

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import native as J_native
from tigerbeetle_tpu.state_machine import StateMachine as J_StateMachine
from tigerbeetle_tpu.vsr import header as J_header
from tigerbeetle_tpu.vsr import storage as J_storage
from tigerbeetle_tpu.vsr.replica import Replica as J_Replica
from tigerbeetle_tpu.vsr.replica import ReplicaOptions as J_Options
from tigerbeetle_tpu_torch import StateMachine as P_StateMachine
from tigerbeetle_tpu_torch import multi_batch
from tigerbeetle_tpu_torch import native as P_native
from tigerbeetle_tpu_torch.trace.context import mint_context
from tigerbeetle_tpu_torch.types import (
    Account, AccountFilter, AccountFilterFlags, AccountFlags, Operation,
    Transfer, TransferFlags)
from tigerbeetle_tpu_torch.vsr import header as P_header
from tigerbeetle_tpu_torch.vsr import storage as P_storage
from tigerbeetle_tpu_torch.vsr.replica import Replica as P_Replica
from tigerbeetle_tpu_torch.vsr.replica import ReplicaOptions as P_Options

CLUSTER = 0x7E57
CAPS = (1 << 10, 1 << 12)
INTERVAL = 4          # a checkpoint every 4 ops: several in a short stream
S = 10**9
# A string condition: evaluated when the test runs, so collecting this file
# builds nothing.
needs_native = pytest.mark.skipif(
    "not P_native.available()",
    reason="no C++ toolchain for the native engine")


@pytest.fixture
def jax_native():
    """The JAX package's native engine, loaded whole. That package links its
    library in place at first use (`g++ -o native/libtb_storage.so`) and
    remembers a failed load for the life of the process, so a test worker
    that loads it while another worker is still linking it reads a partial
    file and would run on plain file IO. Wait for the link to end and load
    again."""
    deadline = _clock.monotonic() + 180
    while J_native.load() is None and _clock.monotonic() < deadline:
        _clock.sleep(0.5)
        J_native._tried = False


class _Bus:
    def __init__(self):
        self.sent: list = []

    def send_to_replica(self, dst, msg) -> None:
        self.sent.append(("replica", dst, msg.pack()))

    def send_to_client(self, client_id, msg) -> None:
        self.sent.append(("client", client_id, msg.pack()))


class _Time:
    def __init__(self):
        self.now = 1_700_000_000 * S

    def monotonic(self) -> int:
        return self.now

    def realtime(self) -> int:
        return self.now


def _sm(pkg: str, engine: str):
    if pkg == "P":
        return lambda: P_StateMachine(engine, a_cap=CAPS[0], t_cap=CAPS[1],
                                      device="cpu")
    return lambda: J_StateMachine(engine=engine, a_cap=CAPS[0], t_cap=CAPS[1])


class _Side:
    """One package's replica over its own storage."""

    def __init__(self, pkg, storage, engine, time, replica_id=0,
                 replica_count=1, fmt=True):
        self.pkg, self.storage, self.time = pkg, storage, time
        self.Replica = P_Replica if pkg == "P" else J_Replica
        self.Options = P_Options if pkg == "P" else J_Options
        self.H = P_header if pkg == "P" else J_header
        self.engine, self.rid, self.count = engine, replica_id, replica_count
        if fmt:
            self.Replica.format(storage, cluster=CLUSTER,
                                replica_id=replica_id,
                                replica_count=replica_count)
        self.bus = _Bus()
        self.start()

    def start(self) -> None:
        """A new process over the same storage: a new Replica, open()."""
        self.r = self.Replica(
            cluster=CLUSTER, replica_id=self.rid, replica_count=self.count,
            storage=self.storage, bus=self.bus, time=self.time,
            state_machine_factory=_sm(self.pkg, self.engine),
            options=self.Options(checkpoint_interval=INTERVAL))
        self.r.open()

    def feed(self, raw: bytes) -> None:
        self.r.on_message(self.H.Message.unpack(raw))

    def settle_io(self) -> None:
        """Every asynchronous WAL write lands; the acks fire at the next
        tick (deterministic on both sides)."""
        self.r.journal.wait_all(fire=False)

    def zones(self) -> dict:
        off = self.storage.layout.zone_offsets
        names = list(off)
        return {z: self.storage.read(z, 0, off[names[i + 1]] - off[z])
                for i, z in enumerate(names[:-1])}


class _Pair:
    def __init__(self, p: _Side, j: _Side, time: _Time):
        self.p, self.j, self.time = p, j, time
        self.checked = 0

    def same(self, label: str) -> None:
        assert self.p.bus.sent == self.j.bus.sent, label
        ck = self.p.r.superblock.op_checkpoint
        assert ck == self.j.r.superblock.op_checkpoint, label
        if ck != self.checked:
            self.checked = ck
            assert self.p.zones() == self.j.zones(), \
                f"{label}: storage zones differ at checkpoint {ck}"
        assert (self.p.r.op, self.p.r.commit_min) == \
            (self.j.r.op, self.j.r.commit_min), label

    def step(self, raw: bytes, label: str, dt: int = 5_000_000) -> None:
        self.p.feed(raw)
        self.j.feed(raw)
        self.tick(label, dt)

    def tick(self, label: str, dt: int = 5_000_000) -> None:
        self.time.now += dt
        for side in (self.p, self.j):
            side.settle_io()
            side.r.tick()
        self.same(label)


def _request(client: int, request: int, op: Operation, body: bytes,
             traced: bool = True) -> bytes:
    h = P_header.Header(command=P_header.Command.request, cluster=CLUSTER,
                        client=client, request=request, operation=int(op),
                        trace_ctx=(mint_context(client, request) if traced
                                   else None))
    return P_header.Message(h.finalize(body), body=body).pack()


def _enc(objs, size=128) -> bytes:
    return multi_batch.encode([b"".join(o.pack() for o in objs)], size)


def _stream(seed: int = 1):
    """(client, operation, body) requests: accounts, plain transfers,
    pendings (1 s timeouts among them), posts and voids, a linked chain
    with a failing member, failing lanes, lookups and queries."""
    rng = random.Random(seed)
    hist = int(AccountFlags.history)
    out = [(1, Operation.create_accounts, _enc(
        [Account(id=i, ledger=1, code=1 + i % 3, user_data_64=i % 4,
                 flags=hist if i == 3 else 0) for i in range(1, 33)]))]
    next_id, pend = 1000, []
    for k in range(10):
        objs = []
        for _ in range(16):
            dr = rng.randrange(1, 33)
            cr = dr % 32 + 1
            flags, timeout = 0, 0
            if rng.random() < 0.2:
                flags, timeout = int(TransferFlags.pending), rng.choice((0, 1))
                pend.append(next_id)
            objs.append(Transfer(id=next_id, debit_account_id=dr,
                                 credit_account_id=cr,
                                 amount=rng.randrange(1, 1000), ledger=1,
                                 code=1, user_data_32=k, flags=flags,
                                 timeout=timeout))
            next_id += 1
        if k == 4:
            objs[2] = Transfer(id=objs[2].id, debit_account_id=1,
                               credit_account_id=2, amount=1, ledger=1,
                               code=1, flags=int(TransferFlags.linked))
            objs[3] = Transfer(id=objs[3].id, debit_account_id=1,
                               credit_account_id=1, amount=1, ledger=1,
                               code=1)
        if k in (6, 8) and pend:
            take, pend = pend[:3], pend[3:]
            for j, pid in enumerate(take):
                objs[j] = Transfer(
                    id=next_id + j, pending_id=pid, ledger=0, code=0,
                    amount=0, flags=int(
                        TransferFlags.post_pending_transfer if j % 2
                        else TransferFlags.void_pending_transfer))
            next_id += 3
        out.append((2 + k % 3, Operation.create_transfers, _enc(objs)))
    out.append((2, Operation.lookup_accounts, multi_batch.encode(
        [b"".join(i.to_bytes(16, "little") for i in (1, 3, 99))], 16)))
    out.append((3, Operation.lookup_transfers, multi_batch.encode(
        [b"".join(i.to_bytes(16, "little") for i in (1000, 1017, 5))], 16)))
    both = int(AccountFilterFlags.debits | AccountFilterFlags.credits)
    out.append((4, Operation.get_account_transfers, multi_batch.encode(
        [AccountFilter(account_id=3, limit=50, flags=both).pack()], 128)))
    return out


def _storages(kind, tmp_path):
    if kind == "memory":
        return (P_storage.MemoryStorage(P_storage.TEST_LAYOUT),
                J_storage.MemoryStorage(J_storage.TEST_LAYOUT))
    return (P_storage.FileStorage(str(tmp_path / "p.tb"),
                                  P_storage.TEST_LAYOUT, create=True),
            J_storage.FileStorage(str(tmp_path / "j.tb"),
                                  J_storage.TEST_LAYOUT, create=True))


@pytest.mark.parametrize("engine", ["oracle", "device"])
def test_replica_stream_crash_and_duplicate_equal(engine):
    """A solo replica of each package fed one request stream: every
    message sent and every zone at each checkpoint equal; a pulse once
    the pendings' 1 s timeouts pass; a crash at least two ops past a
    checkpoint and `open`, which replays them from the WAL, equal; a duplicate request answered from the session with the cached
    bytes, the op number unmoved."""
    time = _Time()
    ps, js = _storages("memory", None)
    pair = _Pair(_Side("P", ps, engine, time), _Side("J", js, engine, time),
                 time)
    requests, replies, crashed = {}, {}, False
    for i, (client, op, body) in enumerate(_stream()):
        n = requests.get(client, 0) + 1
        requests[client] = n
        raw = _request(client, n, op, body)
        pair.step(raw, f"request {i}")
        last = pair.p.bus.sent[-1]
        assert last[0] == "client" and last[1] == client
        replies[(client, n)] = (raw, last[2])
        suffix = pair.p.r.commit_min - pair.p.r.superblock.op_checkpoint
        if not crashed and i >= 9 and suffix >= 2:
            crashed = True
            pair.time.now += 2 * S
            pair.tick("two seconds on")
            before = pair.p.r.commit_min
            pair.p.start()
            pair.j.start()
            assert pair.p.r.commit_min == pair.j.r.commit_min == before
            pair.same("after the restart")
    assert crashed and pair.checked >= 8
    # Expiry pulses the replica issued itself took ops of their own.
    assert pair.p.r.commit_min > len(_stream())
    # The duplicate: the last request of client 2 again.
    raw, reply = replies[(2, requests[2])]
    op_before = pair.p.r.op
    n_sent = len(pair.p.bus.sent)
    pair.step(raw, "the duplicate")
    assert pair.p.bus.sent[n_sent:] == [("client", 2, reply)]
    assert pair.p.r.op == op_before


@needs_native
def test_backup_windows_from_native_data_file(tmp_path, jax_native):
    """A backup (replica 1 of 3) of each package on a native-engine
    FileStorage takes the primary's prepares; its prepare_oks wait for
    the WAL writes (deferred to the next tick). One commit message then
    covers the suffix, which the device engine commits as windows:
    prepare_oks, zones at each checkpoint and the ledger's window routes
    equal to the JAX ledger's."""
    time = _Time()
    ps, js = _storages("file", tmp_path)
    assert ps.aio is not None and js.aio is not None
    pair = _Pair(_Side("P", ps, "device", time, replica_id=1,
                       replica_count=3),
                 _Side("J", js, "device", time, replica_id=1,
                       replica_count=3), time)
    from tigerbeetle_tpu_torch.vsr.checksum import checksum

    parent = checksum(CLUSTER.to_bytes(16, "little"), domain=b"genesis")
    reqs = [s for s in _stream() if s[1] in (Operation.create_accounts,
                                              Operation.create_transfers)]
    rng = random.Random(5)
    prepares = []
    ts = time.now
    for op_no, (client, op, body) in enumerate(reqs[:9], start=1):
        ts += 10_000
        h = P_header.Header(
            command=P_header.Command.prepare, cluster=CLUSTER, replica=0,
            view=0, op=op_no, commit=0, timestamp=ts, operation=int(op),
            client=client, request=op_no, parent=parent,
            release=pair.p.r.release,
            trace_ctx=mint_context(client, op_no))
        m = P_header.Message(h.finalize(body), body=body)
        parent = m.header.checksum
        prepares.append(m.pack())
    # A first tick before any prepare starts the commit-progress watchdog
    # from now (as a cluster's first tick does).
    pair.tick("the first tick")
    order = list(range(len(prepares)))
    middle = order[1:4]
    rng.shuffle(middle)
    order[1:4] = middle
    for i in order:
        pair.p.feed(prepares[i])
        pair.j.feed(prepares[i])
    pair.tick("the prepares")
    oks = [s for s in pair.p.bus.sent
           if P_header.Message.unpack(s[2]).header.command
           == P_header.Command.prepare_ok]
    assert len(oks) == len(prepares)
    commit = P_header.Header(command=P_header.Command.commit,
                             cluster=CLUSTER, replica=0, view=0,
                             commit=len(prepares))
    pair.p.feed(P_header.Message(commit.finalize()).pack())
    pair.j.feed(P_header.Message(commit.finalize()).pack())
    pair.tick("the commit")
    assert pair.p.r.commit_min == len(prepares)
    assert pair.p.r._windows_committed == pair.j.r._windows_committed >= 1
    assert pair.p.r.state_machine.led.window_routes == \
        pair.j.r.state_machine.led.window_routes
    pair.p.storage.close()
    pair.j.storage.close()


@needs_native
def test_jax_data_file_opened_by_the_port(tmp_path, jax_native):
    """A data file the JAX replica wrote (native engine, oracle engine,
    a checkpoint and journaled ops past it) is opened by the port's
    replica, which replays the same ops and answers the next requests as
    the JAX replica does from a copy of the file, both on the native
    engine. The requests carry no trace context: the JAX package's native
    WAL scan checks a header over the context that rides outside its
    checksum, and takes a traced prepare for an unknown slot (the port's
    scan zeroes that region; tests/test_torch_vsr.py)."""
    time = _Time()
    path = str(tmp_path / "j.tb")
    js = J_storage.FileStorage(path, J_storage.TEST_LAYOUT, create=True)
    writer = _Side("J", js, "oracle", time)
    stream = _stream()
    count = {}
    for client, op, body in stream[:6]:
        count[client] = count.get(client, 0) + 1
        writer.feed(_request(client, count[client], op, body, traced=False))
        time.now += 5_000_000
        writer.settle_io()
        writer.r.tick()
    assert writer.r.superblock.op_checkpoint == 4
    suffix = writer.r.commit_min
    assert suffix >= 6
    js.close()
    shutil.copy(path, tmp_path / "p.tb")
    j2 = J_storage.FileStorage(path, J_storage.TEST_LAYOUT)
    p2 = P_storage.FileStorage(str(tmp_path / "p.tb"), P_storage.TEST_LAYOUT)
    assert j2.aio is not None and p2.aio is not None
    pair = _Pair(_Side("P", p2, "oracle", time, fmt=False),
                 _Side("J", j2, "oracle", time, fmt=False), time)
    pair.checked = 4
    assert pair.p.r.commit_min == pair.j.r.commit_min == suffix
    pair.same("after open")
    for client, op, body in stream[6:10]:
        count[client] = count.get(client, 0) + 1
        pair.step(_request(client, count[client], op, body, traced=False),
                  f"request {count}")
    assert pair.p.r.superblock.op_checkpoint >= 8
    # The replayed ops' replies (open re-commits the WAL suffix), then
    # the four new requests'.
    assert [s[0] for s in pair.p.bus.sent].count("client") >= 4
    pair.p.storage.close()
    pair.j.storage.close()
