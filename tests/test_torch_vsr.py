"""The port's replica components against the JAX package's.

The journal (WAL), client sessions, clock, fault detector, repair budget,
native storage engine, snapshot codec, grid scrubber, message bus and
`Replica.format` of `tigerbeetle_tpu_torch` are copies of the JAX
package's host modules: the same inputs must give the same bytes (WAL
zones, session blobs, data files, wire frames) and the same decisions
(slot classes, clock intervals, scrub faults). Nothing here runs a card.
"""

import os
import random
import time

import pytest

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import constants as J_constants
from tigerbeetle_tpu import multiversion as J_mv
from tigerbeetle_tpu.vsr.checksum import checksum as j_checksum
from tigerbeetle_tpu.vsr import clock as J_clock
from tigerbeetle_tpu.vsr import client_sessions as J_sessions
from tigerbeetle_tpu.vsr import fault_detector as J_fd
from tigerbeetle_tpu.vsr import header as J_header
from tigerbeetle_tpu.vsr import journal as J_journal
from tigerbeetle_tpu.vsr import repair_budget as J_rb
from tigerbeetle_tpu.vsr import storage as J_storage
from tigerbeetle_tpu_torch import constants as P_constants
from tigerbeetle_tpu_torch import multiversion as P_mv
from tigerbeetle_tpu_torch import native as P_native
from tigerbeetle_tpu_torch.trace.context import mint_context
from tigerbeetle_tpu_torch.vsr.checksum import _SEED
from tigerbeetle_tpu_torch.vsr.checksum import checksum as p_checksum
from tigerbeetle_tpu_torch.vsr import clock as P_clock
from tigerbeetle_tpu_torch.vsr import client_sessions as P_sessions
from tigerbeetle_tpu_torch.vsr import fault_detector as P_fd
from tigerbeetle_tpu_torch.vsr import header as P_header
from tigerbeetle_tpu_torch.vsr import journal as P_journal
from tigerbeetle_tpu_torch.vsr import repair_budget as P_rb
from tigerbeetle_tpu_torch.vsr import storage as P_storage

LAYOUT = P_storage.TEST_LAYOUT
# A string condition: evaluated when the test runs, so collecting this file
# builds nothing.
needs_native = pytest.mark.skipif(
    "not P_native.available()",
    reason="no C++ toolchain for the native engine")


def _prepares(H, n: int, traced: bool, seed: int = 3) -> list:
    """n chained prepares of `H` (a header module), bodies and trace
    contexts made from `seed`; every second one traced when `traced`."""
    rng = random.Random(seed)
    out, parent = [], 0
    for op in range(1, n + 1):
        body = rng.randbytes(97 * op)
        ctx = (mint_context(5, op) if traced and op % 2 else None)
        if ctx is not None and H is J_header:
            from tigerbeetle_tpu.trace.context import TraceContext

            ctx = TraceContext.unpack(ctx.pack())
        h = H.Header(command=H.Command.prepare, cluster=9, replica=0,
                     view=1, op=op, parent=parent, operation=138,
                     client=5, request=op, timestamp=10**12 + op,
                     trace_ctx=ctx)
        m = H.Message(h.finalize(body), body=body)
        out.append(m)
        parent = m.header.checksum
    return out


def _zones(storage, names=("wal_headers", "wal_prepares")) -> dict:
    lay = storage.layout
    size = {"wal_headers": lay.slot_count * 256,
            "wal_prepares": lay.slot_count * lay.message_size_max,
            "client_replies": lay.clients_max * lay.message_size_max}
    return {z: storage.read(z, 0, size[z]) for z in names}


def _corrupt(write, journal):
    """The torn and corrupt slots: op 3's body (faulty), op 5's ring
    header (clean from its prepare), op 7's both (unknown)."""
    psize = LAYOUT.message_size_max
    zones = LAYOUT.zone_offsets
    write(zones["wal_prepares"] + journal.slot_for_op(3) * psize + 260)
    write(zones["wal_headers"] + journal.slot_for_op(5) * 256 + 40)
    write(zones["wal_prepares"] + journal.slot_for_op(7) * psize + 270)
    write(zones["wal_headers"] + journal.slot_for_op(7) * 256 + 40)


def _scan(journal):
    slots = journal.recover()
    return ([(s.state.value, s.header.checksum if s.header else None)
             for s in slots], sorted(journal.faulty), journal.op_max())


def test_config_fingerprint_and_release_equal():
    """The ping's cluster fingerprint and the release numbers are the JAX
    package's, so replicas of both packages recognize one another."""
    for extra in ((), (32, 65536, 8192), (1024, 1 << 20, 1 << 16)):
        assert P_constants.config_fingerprint(extra) == \
            J_constants.config_fingerprint(extra)
    for name in ("JOURNAL_SLOT_COUNT", "PIPELINE_PREPARE_QUEUE_MAX",
                 "CLIENTS_MAX", "SUPERBLOCK_COPIES",
                 "VSR_OPERATIONS_RESERVED"):
        assert getattr(P_constants, name) == getattr(J_constants, name)
    assert P_mv.RELEASE == J_mv.RELEASE
    assert P_mv.release_str(P_mv.RELEASE) == J_mv.release_str(J_mv.RELEASE)
    for rel in (J_mv.RELEASE - 1, J_mv.RELEASE, J_mv.RELEASE + 1):
        p, j = P_mv.ReleaseTracker(own=P_mv.RELEASE), \
            J_mv.ReleaseTracker(own=J_mv.RELEASE)
        assert (p.openable(rel), p.compatible(rel)) == \
            (j.openable(rel), j.compatible(rel))


@needs_native
def test_checksum_native_equal():
    """The native BLAKE2b-128 equals the port's and the JAX package's
    `checksum` for every size and domain."""
    for size in (0, 1, 63, 64, 127, 128, 129, 4096, 100_001):
        data = os.urandom(size)
        for domain in (b"", b"hdr", b"body", b"ckptroot"):
            want = j_checksum(data, domain)
            assert p_checksum(data, domain) == want
            assert P_native.checksum_native(data, _SEED + domain) == want


def test_overlapping_grid_writes_land_in_order(tmp_path):
    """The native engine's workers may run two in-flight writes in either
    order, so a grid write first settles any pending write it overlaps:
    the later bytes land. Disjoint writes stay in flight together."""
    if not P_native.available():
        pytest.skip("no C++ toolchain for the native engine")
    fs = P_storage.FileStorage(str(tmp_path / "grid"), LAYOUT, create=True)
    assert fs.aio is not None
    want = bytearray(4096)
    rng = random.Random(5)
    for i in range(64):
        off, n = rng.randrange(2048), rng.randrange(1, 900)
        data = bytes([i + 1]) * n
        fs.write("grid", off, data)
        want[off:off + n] = data
        spans = sorted(fs._grid_pending.values())
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), spans
    fs.write("grid", 3000, b"x" * 10)
    fs.write("grid", 3500, b"y" * 10)
    assert len(fs._grid_pending) >= 2
    want[3000:3010], want[3500:3510] = b"x" * 10, b"y" * 10
    fs.sync()
    assert fs.read("grid", 0, 4096) == bytes(want)
    fs.close()


@pytest.mark.parametrize("path", ["python", "native"])
def test_journal_zones_and_recovery_equal(path, tmp_path, monkeypatch):
    """Eight chained prepares (half of them carrying a trace context)
    appended by the port's Journal — synchronously on a MemoryStorage, or
    asynchronously through the native engine on a FileStorage — leave
    WAL zones byte-equal to the JAX Journal's on a MemoryStorage; after
    the same corruptions the recovery scan classifies every slot as the
    JAX package's Python scan does (op 3 faulty, op 5 clean from its
    prepare, op 7 unknown), and the clean prepares read back equal."""
    if path == "native" and not P_native.available():
        pytest.skip("no C++ toolchain for the native engine")
    jm = J_storage.MemoryStorage(J_storage.TEST_LAYOUT)
    jj = J_journal.Journal(jm)
    for m in _prepares(J_header, 8, traced=True):
        jj.append(m)
    if path == "python":
        ps = P_storage.MemoryStorage(LAYOUT)
    else:
        ps = P_storage.FileStorage(str(tmp_path / "wal"), LAYOUT, create=True)
        assert ps.native is not None and ps.aio is not None
    pj = P_journal.Journal(ps)
    fired = []
    for m in _prepares(P_header, 8, traced=True):
        durable = pj.append(m, on_durable=lambda op=m.header.op:
                            fired.append(op))
        assert durable == (path == "python")
        got = pj.read_prepare(m.header.op)
        assert got.header.checksum == m.header.checksum
    pj.wait_all()
    assert fired == list(range(1, 9))
    assert _zones(ps) == _zones(jm)

    def flip_j(pos):
        jm.data[pos] ^= 0xFF

    _corrupt(flip_j, jj)
    jrec = J_journal.Journal(jm)
    want = _scan(jrec)
    if path == "python":
        def flip_p(pos):
            ps.data[pos] ^= 0xFF
        _corrupt(flip_p, pj)
        scanned = P_journal.Journal(ps)
    else:
        ps.close()
        raw = bytearray((tmp_path / "wal").read_bytes())

        def flip_f(pos):
            raw[pos] ^= 0xFF
        _corrupt(flip_f, pj)
        (tmp_path / "wal").write_bytes(bytes(raw))
        ps = P_storage.FileStorage(str(tmp_path / "wal"), LAYOUT)
        assert ps.native is not None
        scanned = P_journal.Journal(ps)
    got = _scan(scanned)
    assert got == want
    states = [s for s, _ in want[0]]
    assert states[jrec.slot_for_op(3)] == "faulty"
    assert states[jrec.slot_for_op(5)] == "clean"
    assert states[jrec.slot_for_op(7)] == "unknown"
    for op in (1, 2, 4, 5, 6, 8):
        assert scanned.read_prepare(op).pack() == \
            jrec.read_prepare(op).pack()
    if path == "native":
        ps.close()


@needs_native
def test_native_scan_equals_python_scan_on_traced_prepares(tmp_path,
                                                           monkeypatch):
    """A prepare's trace context rides in the header's reserved region,
    outside its checksum. The port's native WAL scan checks the header
    with that region zeroed, as `Header.calculate_checksum` does, so a
    traced prepare is clean on both paths; formatted-empty slots are
    clean too, and a prepare whose ring header is still the reserved one
    (the header write torn) is taken from its prepare."""
    path = str(tmp_path / "wal")
    fs = P_storage.FileStorage(path, LAYOUT, create=True)
    for slot in range(LAYOUT.slot_count):
        h = P_header.Header(command=P_header.Command.reserved, cluster=9,
                            op=slot).finalize()
        fs.write("wal_headers", slot * 256, h.pack())
    pj = P_journal.Journal(fs)
    msgs = _prepares(P_header, 10, traced=True)
    for m in msgs[:9]:
        pj.append(m)
    pj.wait_all()
    # op 10: its prepare lands, its ring header never does.
    fs.write("wal_prepares", pj.slot_for_op(10) * LAYOUT.message_size_max,
             msgs[9].pack())
    fs.close()
    native_scan = _scan(P_journal.Journal(P_storage.FileStorage(path,
                                                                LAYOUT)))
    monkeypatch.setattr(P_native, "available", lambda: False)
    plain = P_storage.FileStorage(path, LAYOUT)
    assert plain.native is None
    python_scan = _scan(P_journal.Journal(plain))
    plain.close()
    assert native_scan == python_scan
    assert [s for s, _ in native_scan[0]] == ["clean"] * LAYOUT.slot_count
    assert native_scan[2] == 10


@needs_native
def test_native_scan_equals_the_jax_python_scan_on_traced_prepares(
        tmp_path):
    """The same WAL zones, written by the JAX package's Journal (traced
    prepares over reserved ring headers, the last prepare without its
    ring header, then the torn and corrupt slots of `_corrupt`), scanned
    by the port's native engine and by the JAX package's Python scan:
    the same slot classes, faults and op_max. The JAX package's own
    native scan is not the reference here, as it reads a traced prepare
    as an unknown slot."""
    jm = J_storage.MemoryStorage(J_storage.TEST_LAYOUT)
    assert getattr(jm, "native", None) is None
    for slot in range(LAYOUT.slot_count):
        h = J_header.Header(command=J_header.Command.reserved, cluster=9,
                            op=slot).finalize()
        jm.write("wal_headers", slot * 256, h.pack())
    jj = J_journal.Journal(jm)
    msgs = _prepares(J_header, 10, traced=True)
    for m in msgs[:9]:
        jj.append(m)
    jm.write("wal_prepares", jj.slot_for_op(10) * LAYOUT.message_size_max,
             msgs[9].pack())

    def flip(pos):
        jm.data[pos] ^= 0xFF
    _corrupt(flip, jj)
    path = str(tmp_path / "wal")
    fs = P_storage.FileStorage(path, LAYOUT, create=True)
    for zone, data in _zones(jm).items():
        fs.write(zone, 0, data)
    fs.close()
    fs = P_storage.FileStorage(path, LAYOUT)
    assert fs.native is not None
    native_scan = _scan(P_journal.Journal(fs))
    fs.close()
    want = _scan(J_journal.Journal(jm))
    assert native_scan == want
    states = [s for s, _ in want[0]]
    assert states[jj.slot_for_op(2)] == "clean"     # untraced
    assert states[jj.slot_for_op(9)] == "clean"     # traced
    assert states[jj.slot_for_op(10)] == "clean"    # from its prepare
    assert states[jj.slot_for_op(3)] == "faulty"
    assert want[2] == 10


def _sessions_reply(H, client: int, request: int, size: int):
    body = bytes([client % 251]) * size
    h = H.Header(command=H.Command.reply, cluster=1, client=client,
                 request=request, op=request, commit=request,
                 timestamp=10**12 + request,
                 trace_ctx=None)
    return H.Message(h.finalize(body), body=body)


def test_client_sessions_pack_and_restore_equal():
    """The same replies put into both packages' session tables (the
    table filled, then an eviction) give byte-equal `pack` blobs and
    reply slots; each package restores the other's blob to the same
    sessions, and a corrupt reply slot is missing in both."""
    ps = P_storage.MemoryStorage(LAYOUT)
    js = J_storage.MemoryStorage(J_storage.TEST_LAYOUT)
    p, j = P_sessions.ClientSessions(ps), J_sessions.ClientSessions(js)
    rng = random.Random(7)
    plan = [(c, r) for r in (1, 2) for c in range(1, LAYOUT.clients_max + 1)]
    plan += [(100, 9), (3, 40), (101, 10)]
    for client, request in plan:
        size = rng.randrange(0, 3000)
        ev_p = p.put_reply(client, request,
                           _sessions_reply(P_header, client, request, size))
        ev_j = j.put_reply(client, request,
                           _sessions_reply(J_header, client, request, size))
        assert ev_p == ev_j
        assert p.pack() == j.pack()
    assert _zones(ps, ("client_replies",)) == _zones(js, ("client_replies",))
    blob = j.pack()
    for Sess, store, other in ((P_sessions, ps, blob), (J_sessions, js,
                                                         p.pack())):
        restored = Sess.ClientSessions(store)
        restored.restore(other)
        assert restored.pack() == blob
    slot = p.get(3)["slot"]
    for store in (ps, js):
        store.data[store.layout.zone_offsets["client_replies"]
                   + slot * store.layout.message_size_max + 300] ^= 0xFF
    rp, rj = P_sessions.ClientSessions(ps), J_sessions.ClientSessions(js)
    rp.restore(blob)
    rj.restore(blob)
    assert rp.missing_replies() == rj.missing_replies() == [3]


class _Time:
    def __init__(self, now: int, skew: int = 0):
        self.now, self.skew = now, skew

    def monotonic(self) -> int:
        return self.now

    def realtime(self) -> int:
        return self.now + self.skew


def test_clock_offsets_and_synchronized_interval_equal():
    """Marzullo over random intervals, and the clock's agreed offset and
    synchronized time over a stream of ping samples (fresh, stale,
    disagreeing), are equal in both packages."""
    rng = random.Random(11)
    for _ in range(200):
        ivs = []
        for _ in range(rng.randrange(1, 7)):
            lo = rng.randrange(-1000, 1000)
            ivs.append((lo, lo + rng.randrange(0, 400)))
        p = P_clock.marzullo_with_count([P_clock.Interval(*x) for x in ivs])
        j = J_clock.marzullo_with_count([J_clock.Interval(*x) for x in ivs])
        assert (p[0].lo, p[0].hi, p[1]) == (j[0].lo, j[0].hi, j[1])
    for replica_count in (3, 5):
        tp, tj = _Time(10**12, 5_000), _Time(10**12, 5_000)
        cp = P_clock.Clock(0, replica_count, tp)
        cj = J_clock.Clock(0, replica_count, tj)
        for step in range(60):
            peer = rng.randrange(1, replica_count)
            tx = tp.now - rng.randrange(0, 2_000_000)
            rx = tp.now
            peer_rt = tp.now + rng.randrange(-3_000_000, 3_000_000)
            if step % 17 == 0:
                peer_rt += 10**9      # a peer far off
            cp.learn(peer, tx, peer_rt, rx)
            cj.learn(peer, tx, peer_rt, rx)
            op, oj = cp.offset(), cj.offset()
            assert (op is None) == (oj is None)
            if op is not None:
                assert (op.lo, op.hi) == (oj.lo, oj.hi)
            assert cp.realtime_synchronized() == cj.realtime_synchronized()
            adv = rng.choice((1_000_000, 50_000_000, 3_000_000_000))
            tp.now += adv
            tj.now += adv


def test_fault_detector_and_repair_budget_equal():
    """Peer suspicion and repair pacing decide alike on one event
    stream."""
    rng = random.Random(13)
    fp, fj = P_fd.FaultDetector(suspect_multiplier=4.0), \
        J_fd.FaultDetector(suspect_multiplier=4.0)
    bp, bj = P_rb.RepairBudget(), J_rb.RepairBudget()
    now = 10**9
    fp.reset(now)
    fj.reset(now)
    for _ in range(400):
        now += rng.choice((1_000_000, 20_000_000, 400_000_000))
        if rng.random() < 0.6:
            fp.observe_progress(now)
            fj.observe_progress(now)
        assert fp.suspect(now) == fj.suspect(now)
        assert fp.deadline_ns() == fj.deadline_ns()
        k = rng.randrange(1, 4)
        assert bp.spend(now, k) == bj.spend(now, k)
        assert bp.available(now) == bj.available(now)


def test_replica_format_zones_equal(tmp_path):
    """`Replica.format` writes the same data file in both packages: on a
    MemoryStorage, and through the port's FileStorage (native engine)
    against the JAX package's."""
    from tigerbeetle_tpu.vsr.replica import Replica as J_Replica
    from tigerbeetle_tpu_torch.vsr.replica import Replica as P_Replica

    for cluster, rid, count in ((0, 0, 1), (0xC1A57E12, 2, 3)):
        ps = P_storage.MemoryStorage(LAYOUT)
        js = J_storage.MemoryStorage(J_storage.TEST_LAYOUT)
        P_Replica.format(ps, cluster=cluster, replica_id=rid,
                         replica_count=count)
        J_Replica.format(js, cluster=cluster, replica_id=rid,
                         replica_count=count)
        assert bytes(ps.data) == bytes(js.data)
    fs = P_storage.FileStorage(str(tmp_path / "p"), LAYOUT, create=True)
    P_Replica.format(fs, cluster=0, replica_id=0, replica_count=1)
    fs.sync()
    fs.close()
    js = J_storage.FileStorage(str(tmp_path / "j"), J_storage.TEST_LAYOUT,
                               create=True)
    J_Replica.format(js, cluster=0, replica_id=0, replica_count=1)
    js.sync()
    js.close()
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


def _oracle_state(pkg: str):
    """An oracle engine's state after accounts, transfers, a pending and
    its post, in the package `pkg` ("P" or "J")."""
    if pkg == "P":
        from tigerbeetle_tpu_torch import StateMachine, multi_batch
        from tigerbeetle_tpu_torch.types import (
            Account, Operation, Transfer, TransferFlags)
        sm = StateMachine("oracle", device="cpu")
    else:
        from tigerbeetle_tpu import multi_batch
        from tigerbeetle_tpu.state_machine import StateMachine
        from tigerbeetle_tpu.types import (
            Account, Operation, Transfer, TransferFlags)
        sm = StateMachine("oracle")
    enc = lambda objs: multi_batch.encode(  # noqa: E731
        [b"".join(o.pack() for o in objs)], 128)
    sm.commit(Operation.create_accounts, enc(
        [Account(id=i, ledger=1, code=1, flags=(4 if i == 3 else 0))
         for i in range(1, 5)]), 10**12)
    sm.commit(Operation.create_transfers, enc(
        [Transfer(id=100 + k, debit_account_id=1 + k % 4,
                  credit_account_id=1 + (k + 1) % 4, amount=5 + k,
                  ledger=1, code=1) for k in range(12)]
        + [Transfer(id=200, debit_account_id=1, credit_account_id=2,
                    amount=9, ledger=1, code=1,
                    flags=int(TransferFlags.pending), timeout=60)]),
        10**12 + 100)
    sm.commit(Operation.create_transfers, enc(
        [Transfer(id=201, pending_id=200, amount=4, ledger=1, code=1,
                  flags=int(TransferFlags.post_pending_transfer))]),
        10**12 + 200)
    return sm.state


def test_snapshot_codec_equal():
    """The cluster harness's whole-state codec encodes equal states to
    equal bytes in both packages, and decodes the other's bytes."""
    from tigerbeetle_tpu.vsr import snapshot as J_snap
    from tigerbeetle_tpu_torch.vsr import snapshot as P_snap

    raw = P_snap.encode(_oracle_state("P"))
    assert raw == J_snap.encode(_oracle_state("J"))
    assert P_snap.encode(P_snap.decode(raw)) == raw
    assert J_snap.encode(J_snap.decode(raw)) == raw


def _scrubbed(pkg: str):
    """A forest flushed and checkpointed from the oracle state above, one
    of its blocks corrupted, then a full scrub tour: (blocks visited in
    tour order, the faults certify() reports)."""
    if pkg == "P":
        from tigerbeetle_tpu_torch.vsr.durable import DurableState
        from tigerbeetle_tpu_torch.vsr.grid_scrubber import GridScrubber
        store = P_storage.MemoryStorage(LAYOUT)
    else:
        from tigerbeetle_tpu.vsr.durable import DurableState
        from tigerbeetle_tpu.vsr.grid_scrubber import GridScrubber
        store = J_storage.MemoryStorage(J_storage.TEST_LAYOUT)
    durable = DurableState(store)
    durable.checkpoint(_oracle_state(pkg))
    scrub = GridScrubber(durable.forest, origin_seed=2654435761)
    tour = [(name, addr.index, size) for name, addr, size in scrub._tour()]
    victim = tour[len(tour) // 2][1]
    store.data[store.layout.zone_offsets["grid"]
               + victim * store.layout.grid_block_size + 70] ^= 0xFF
    durable.grid.cache.clear()
    faults = [(name, addr.index, size)
              for name, addr, size in scrub.certify()]
    return tour, faults


def test_grid_scrubber_equal():
    """The scrubber tours the same blocks in the same order and reports
    the same corrupt block in both packages."""
    p, j = _scrubbed("P"), _scrubbed("J")
    assert p == j
    assert len(p[1]) == 1


def test_message_bus_frames_between_packages():
    """A request framed by the JAX package's bus reaches the port's
    listening bus intact, and the port's reply reaches the JAX side
    intact (1 MiB frames over localhost TCP)."""
    from tigerbeetle_tpu.vsr.message_bus import MessageBus as J_Bus
    from tigerbeetle_tpu_torch.vsr.message_bus import MessageBus as P_Bus

    got_p, got_j = [], []
    server = P_Bus(cluster=3, on_message=got_p.append,
                   replica_addresses=[("127.0.0.1", 0)], replica_id=0,
                   listen=True)
    port = server.listen_address[1]
    client = J_Bus(cluster=3, on_message=got_j.append,
                   replica_addresses=[("127.0.0.1", port)])
    try:
        body = os.urandom(P_constants.MESSAGE_BODY_SIZE_MAX)
        req = J_header.Header(command=J_header.Command.request, cluster=3,
                              client=42, request=1, operation=138)
        client.send_to_replica(0, J_header.Message(req.finalize(body),
                                                   body=body))
        deadline = time.monotonic() + 30
        while not got_p and time.monotonic() < deadline:
            client.poll(0.01)
            server.poll(0.01)
        assert got_p and got_p[0].pack() == \
            J_header.Message(req, body=body).pack()
        rep = P_header.Header(command=P_header.Command.reply, cluster=3,
                              client=42, request=1, op=1, commit=1)
        reply = P_header.Message(rep.finalize(b"ok" * 8), body=b"ok" * 8)
        server.send_to_client(42, reply)
        while not got_j and time.monotonic() < deadline:
            server.poll(0.01)
            client.poll(0.01)
        assert got_j and got_j[0].pack() == reply.pack()
    finally:
        client.close()
        server.close()
