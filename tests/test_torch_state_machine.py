"""The port's StateMachine against the JAX package's, on the CPU.

The same wire bodies, made from a numpy seed, go to the port's
`tigerbeetle_tpu_torch.StateMachine` on each engine ("oracle", "kernel":
the sequential kernel's plain twin, "device": the write-through ledger)
and to the JAX package's `StateMachine`; every reply must be equal byte
for byte, multi-batch bodies, queries, the deprecated encodings and the
pulse included. Also: input_valid and ProtocolError on malformed bodies,
commit_window (all_or_nothing returning None with the state untouched),
the staged / submitted / resolved pipeline, the metrics counts, the
restored state, and the card as the default device.

The cases repeat the JAX package's tests/test_state_machine.py,
test_device_engine.py, test_lazy_mirror.py, test_window_pipeline.py and
test_overlap_parity.py where they apply. The JAX side runs its "oracle"
engine (its engines' replies are equal by its own tests) except where a
case needs its device engine, at one pad bucket (1024).
"""

import copy
import dataclasses
import struct

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import multi_batch as JMB
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu.state_machine import StateMachine as JSM
from tigerbeetle_tpu_torch import DeviceLedger, StateMachine
from tigerbeetle_tpu_torch import multi_batch as TMB
from tigerbeetle_tpu_torch import state_machine as TSMM
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.oracle import StateMachineOracle
from tigerbeetle_tpu_torch.ops.state_epoch import (device_state_digest,
                                                   oracle_state_digest)

torch.set_num_threads(1)

TS = 10**13
A_CAP = 1 << 10
T_CAP = 1 << 13
O = JT.Operation
TF = JT.TransferFlags
AF = JT.AccountFlags
AFF = JT.AccountFilterFlags
U128_MAX = (1 << 128) - 1
ENGINES = ["oracle", "kernel", "device"]


def port_sm(engine):
    return StateMachine(engine=engine, a_cap=A_CAP, t_cap=T_CAP,
                        device="cpu")


class Pair:
    """A port StateMachine and the JAX package's, fed the same bodies."""

    def __init__(self, engine, jax_engine="oracle"):
        self.port = port_sm(engine)
        self.jax = (JSM(engine=jax_engine, a_cap=A_CAP, t_cap=T_CAP)
                    if jax_engine == "device" else JSM(engine=jax_engine))
        self.replies = 0

    def commit(self, op, body, ts) -> bytes:
        got = self.port.commit(TT.Operation(int(op)), body, ts)
        want = self.jax.commit(op, body, ts)
        assert got == want, (op, ts)
        self.replies += 1
        return got


def acct_body(accts) -> bytes:
    return JMB.encode([b"".join(a.pack() for a in accts)], 128)


def xfer_body(*batches) -> bytes:
    return JMB.encode([b"".join(t.pack() for t in b) for b in batches], 128)


def x(i, dr=0, cr=0, amount=0, ledger=1, code=1, **kw):
    return JT.Transfer(id=i, debit_account_id=dr, credit_account_id=cr,
                       amount=amount, ledger=ledger, code=code, **kw)


def one(op, payload, size) -> bytes:
    return JMB.encode([payload], size)


def ids_body(ids) -> bytes:
    return one(None, b"".join(i.to_bytes(16, "little") for i in ids), 16)


def setup(pair) -> None:
    """The JAX package's `_setup`, as wire bodies."""
    pair.commit(O.create_accounts, acct_body([
        JT.Account(id=1, ledger=1, code=10, user_data_64=7),
        JT.Account(id=2, ledger=1, code=10, flags=int(AF.history)),
        JT.Account(id=3, ledger=1, code=20, user_data_64=7),
        JT.Account(id=4, ledger=2, code=10)]), TS)
    pair.commit(O.create_transfers, xfer_body([
        x(101, 1, 2, 10, code=5, user_data_64=77),
        x(102, 2, 3, 20, code=5),
        x(103, 3, 1, 30, code=6, user_data_64=77),
        x(104, 1, 2, 40, code=6, flags=int(TF.pending))]), TS + 100)


def queries() -> list:
    """One body of every query operation, invalid filters included."""
    both = int(AFF.debits | AFF.credits)
    af = [JT.AccountFilter(account_id=2, limit=100, flags=both),
          JT.AccountFilter(account_id=2, limit=100, flags=int(AFF.credits)),
          JT.AccountFilter(account_id=2, limit=100,
                           flags=both | int(AFF.reversed)),
          JT.AccountFilter(account_id=1, limit=100, user_data_64=77,
                           flags=both),
          JT.AccountFilter(account_id=1, limit=2, flags=both),
          JT.AccountFilter(account_id=0, limit=10, flags=int(AFF.debits)),
          JT.AccountFilter(account_id=1, limit=0, flags=int(AFF.debits)),
          JT.AccountFilter(account_id=1, limit=10),
          JT.AccountFilter(account_id=1, limit=10, timestamp_min=5,
                           timestamp_max=4, flags=int(AFF.debits))]
    qf = [JT.QueryFilter(limit=10, code=10),
          JT.QueryFilter(limit=10, code=10, ledger=1),
          JT.QueryFilter(limit=10, user_data_64=7, flags=1),
          JT.QueryFilter(limit=2), JT.QueryFilter(limit=10, code=6),
          JT.QueryFilter(limit=10), JT.QueryFilter(limit=0)]
    out = [(O.lookup_accounts, ids_body([1, 2, 99, 4])),
           (O.lookup_transfers, ids_body([101, 999, 104])),
           (O.deprecated_lookup_accounts_unbatched,
            b"".join(i.to_bytes(16, "little") for i in (3, 1)))]
    for f in af:
        out.append((O.get_account_transfers, one(None, f.pack(), 128)))
        out.append((O.get_account_balances, one(None, f.pack(), 128)))
    for f in qf:
        out.append((O.query_accounts, one(None, f.pack(), 64)))
        out.append((O.query_transfers, one(None, f.pack(), 64)))
    for lim in (100, 2, 0):
        out.append((O.get_change_events,
                    JT.ChangeEventsFilter(limit=lim).pack()))
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_queries_match_the_jax_state_machine(engine):
    """test_state_machine.py's scenario (accounts, transfers, a posted
    pending) and one body of every query on its filters, valid and
    invalid: every reply equal to the JAX StateMachine's."""
    pair = Pair(engine)
    setup(pair)
    pair.commit(O.create_transfers, xfer_body([
        x(105, pending_id=104, amount=U128_MAX, ledger=0, code=0,
          flags=int(TF.post_pending_transfer))]), TS + 200)
    for op, body in queries():
        pair.commit(op, body, TS + 300)
    events = [TT.ChangeEvent.unpack(r) for r in _split(pair.commit(
        O.get_change_events, JT.ChangeEventsFilter(limit=100).pack(),
        TS + 300), 384)]
    assert [int(e.type) for e in events] == [0, 0, 0, 1, 2]
    assert events[4].transfer_pending_id == 104


def _split(raw, size):
    return [raw[i:i + size] for i in range(0, len(raw), size)]


@pytest.mark.parametrize("engine", ENGINES)
def test_change_events_expiry(engine):
    """A pending with a 1 s timeout, the pulse past it, the change events
    of both (the expiry's transfer is the pending itself)."""
    pair = Pair(engine)
    pair.commit(O.create_accounts, acct_body([
        JT.Account(id=1, ledger=1, code=1),
        JT.Account(id=2, ledger=1, code=1)]), TS)
    pair.commit(O.create_transfers, xfer_body([
        x(10, 1, 2, 5, flags=int(TF.pending), timeout=1)]), TS + 100)
    later = TS + 100 + 2 * 10**9
    assert pair.port.pulse_needed(later) and pair.jax.pulse_needed(later)
    assert pair.commit(O.pulse, b"", later) == b""
    raw = pair.commit(O.get_change_events,
                      JT.ChangeEventsFilter(limit=10).pack(), later)
    assert [TT.ChangeEvent.unpack(r).type for r in _split(raw, 384)] == [
        TT.ChangeEventType.two_phase_pending,
        TT.ChangeEventType.two_phase_expired]
    assert not pair.port.pulse_needed(later)


@pytest.mark.parametrize("engine", ENGINES)
def test_multi_batch_timestamps_advance_per_batch(engine):
    """Each inner batch consumes one timestamp an event, the body's
    timestamp the last one's."""
    pair = Pair(engine)
    pair.commit(O.create_accounts, acct_body([
        JT.Account(id=i, ledger=1, code=1) for i in (1, 2)]), TS)
    out = pair.commit(O.create_transfers, xfer_body(
        [x(1, 1, 2, 1)], [x(2, 1, 2, 2)]), TS + 100)
    r1, r2 = [TT.CreateTransferResult.unpack(p)
              for p in TMB.decode(out, 16)]
    assert (r1.timestamp, r2.timestamp) == (TS + 99, TS + 100)
    assert len(pair.port.state.transfer_by_timestamp) == 2


def _random_bodies(rng, n_bodies, n, first_id=10**6, dup_rate=0.2):
    """Create bodies of 1-3 inner batches: uniform transfers, pendings
    (some timing out), posts and voids of earlier bodies' pendings,
    linked chains, failures (not found, the closed account, a repeated
    id in dup_rate of the batches), debits of the limited account and
    balancing debits."""
    pool, nid, out = [], first_id, []
    for _ in range(n_bodies):
        batches = []
        for _ in range(int(rng.integers(1, 4))):
            batch = []
            for i in range(n):
                dr = int(rng.integers(1, 20))
                cr = dr % 19 + 1
                roll = rng.random()
                if roll < 0.15 and pool:
                    post = rng.random() < 0.5
                    batch.append(x(nid, pending_id=pool.pop(0),
                                   amount=U128_MAX if post else 0,
                                   ledger=0, code=0,
                                   flags=int(TF.post_pending_transfer if post
                                             else TF.void_pending_transfer)))
                elif roll < 0.35:
                    batch.append(x(nid, dr, cr, int(rng.integers(1, 50)),
                                   flags=int(TF.pending),
                                   timeout=int(rng.integers(0, 2))))
                elif roll < 0.42:
                    batch.append(x(nid, dr, cr, 3, flags=int(TF.linked)))
                elif roll < 0.46:
                    batch.append(x(nid, 900 + i, cr, 3))
                elif roll < 0.49:
                    batch.append(x(nid, dr, 21, 3))
                elif roll < 0.55:
                    batch.append(x(nid, 20, cr, int(rng.integers(1, 9))))
                elif roll < 0.58:
                    batch.append(x(nid, 20, cr, 10**6,
                                   flags=int(TF.balancing_debit)))
                else:
                    batch.append(x(nid, dr, cr, int(rng.integers(0, 500))))
                nid += 1
            if rng.random() < dup_rate:
                batch.append(dataclasses.replace(batch[0]))
            batches.append(batch)
        out.append(batches)
        pool += [t.id for b in batches for t in b if t.flags & TF.pending]
    return out


def _accounts21():
    """Accounts 1..21: 20 debit-limited, 21 closed, 8 and 16 with
    history."""
    out = []
    for i in range(1, 22):
        flags = (AF.debits_must_not_exceed_credits if i == 20
                 else AF.closed if i == 21
                 else AF.history if i % 8 == 0 else 0)
        out.append(JT.Account(id=i, ledger=1, code=1 + i % 2,
                              user_data_32=i % 3, flags=int(flags)))
    return out


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", [1, 2])
def test_random_wire_traffic_matches(engine, seed):
    """Seeded multi-batch create bodies (every kind of event the tiers,
    the ladder and the mirror take), a deprecated unbatched and a sparse
    body, a pulse, then every query: replies equal byte for byte."""
    rng = np.random.default_rng(seed)
    pair = Pair(engine)
    pair.commit(O.create_accounts, acct_body(_accounts21()), TS)
    n = 12 if engine == "kernel" else 60
    ts = TS + 1000
    for batches in _random_bodies(rng, 5, n):
        ts += sum(len(b) for b in batches) + 100
        pair.commit(O.create_transfers, xfer_body(*batches), ts)
    extra = [x(9 * 10**6 + i, 1 + i, 2 + i, 1) for i in range(3)]
    ts += 1000
    pair.commit(O.deprecated_create_transfers_unbatched,
                b"".join(t.pack() for t in extra), ts)
    ts += 1000
    pair.commit(O.deprecated_create_transfers_sparse,
                xfer_body([x(0, 1, 2, 1)] + [
                    dataclasses.replace(t, id=t.id + 10) for t in extra]),
                ts)
    ts += 3 * 10**9
    assert pair.port.pulse_needed(ts) == pair.jax.pulse_needed(ts)
    pair.commit(O.pulse, b"", ts)
    both = int(AFF.debits | AFF.credits)
    for op, body in [
            (O.lookup_accounts, ids_body(range(1, 23))),
            (O.lookup_transfers, ids_body(range(10**6, 10**6 + 40))),
            (O.get_account_transfers, one(None, JT.AccountFilter(
                account_id=8, limit=30, flags=both).pack(), 128)),
            (O.get_account_balances, one(None, JT.AccountFilter(
                account_id=16, limit=30, flags=both).pack(), 128)),
            (O.query_accounts, one(None, JT.QueryFilter(
                user_data_32=1, limit=10).pack(), 64)),
            (O.query_transfers, one(None, JT.QueryFilter(
                code=1, limit=25, flags=1).pack(), 64)),
            (O.get_change_events, JT.ChangeEventsFilter(limit=80).pack())]:
        pair.commit(op, body, ts)
    if engine == "device":
        led = pair.port.led
        assert led.fast_batches > 0
        assert (oracle_state_digest(pair.port.state, A_CAP)
                == device_state_digest(led.state))


@pytest.mark.parametrize("engine", ENGINES)
def test_wire_commit_path(engine):
    """test_state_machine.py's wire path: dense create results, lookups,
    the deprecated sparse encoding, get_account_transfers."""
    pair = Pair(engine)
    out = pair.commit(O.create_accounts, acct_body([
        JT.Account(id=i, ledger=1, code=1) for i in (1, 2)]), TS)
    assert len(TMB.decode(out, 16)[0]) == 32
    pair.commit(O.create_transfers, xfer_body(
        [x(100 + i, 1, 2, 10) for i in range(3)]), TS + 100)
    out = pair.commit(O.lookup_transfers, ids_body([100, 999]), TS + 200)
    assert TT.Transfer.unpack(TMB.decode(out, 128)[0]).id == 100
    out = pair.commit(O.deprecated_create_transfers_sparse, xfer_body(
        [x(0, 1, 2, 1), x(200, 1, 2, 1)]), TS + 300)
    assert struct.unpack("<II", TMB.decode(out, 8)[0]) == (0, 5)
    out = pair.commit(O.get_account_transfers, one(None, JT.AccountFilter(
        account_id=1, limit=10, flags=int(AFF.debits | AFF.credits)).pack(),
        128), TS + 400)
    assert len(TMB.decode(out, 128)[0]) // 128 == 4


def test_malformed_bodies_rejected():
    """input_valid agrees with the JAX package's on good and malformed
    bodies of every operation; commit raises ProtocolError on a bad
    one."""
    sm, ref = port_sm("oracle"), JSM(engine="oracle")
    f = JT.AccountFilter(account_id=1, limit=10, flags=int(AFF.debits))
    good = JMB.encode([f.pack()], 128)
    bad_junk = good[:-128] + b"\x99" * 16 + good[-128:-16] + good[-16:]
    bodies = [b"", b"\x01" * 100, b"\x00" * 128, good, bad_junk,
              JMB.encode([f.pack() + f.pack()], 128),
              JMB.encode([b"\x00" * 64], 64), b"\x00" * 64,
              ids_body([1, 2]), b"\x00" * (1 << 20)]
    for op in JT.Operation:
        for body in bodies:
            assert (sm.input_valid(TT.Operation(int(op)), body)
                    == ref.input_valid(op, body)), (op, body[:8])
    with pytest.raises(TSMM.ProtocolError):
        sm.commit(TT.Operation.deprecated_create_transfers_unbatched,
                  b"\x00" * 100, TS)
    assert issubclass(TSMM.ProtocolError, ValueError)
    assert {int(k): dataclasses.astuple(v)
            for k, v in TSMM.OPERATION_SPECS.items()} == {
        int(k): dataclasses.astuple(v)
        for k, v in tigerbeetle_tpu.state_machine.OPERATION_SPECS.items()}


def test_multi_batch_roundtrip():
    """The port's codec gives the JAX package's bytes and raises where it
    raises."""
    for element_size in (8, 16, 64, 128):
        batches = [b"\x01" * element_size * 3, b"", b"\x02" * element_size]
        body = TMB.encode(batches, element_size)
        assert body == JMB.encode(batches, element_size)
        assert TMB.decode(body, element_size) == batches
    for raw in (b"", b"\x00\x00", b"\x01\x00" * 3, b"\xff" * 128):
        with pytest.raises(ValueError):
            TMB.decode(raw, 128)
        with pytest.raises(ValueError):
            JMB.decode(raw, 128)


def _window_bodies(seed, n_windows, w=3, n=40, poison=None, first=10**6):
    """Windows of w create_transfers bodies (one inner batch each):
    uniform transfers and pendings, posts of earlier windows' pendings;
    a repeated id in the middle body of window `poison`."""
    rng = np.random.default_rng(seed)
    out, nid, ts, pool = [], first, TS + 10**6, []
    for k in range(n_windows):
        bodies, tss, made = [], [], []
        for b in range(w):
            batch = []
            for i in range(n):
                dr = int(rng.integers(1, 19))
                if i % 5 == 0 and pool:
                    batch.append(x(nid, pending_id=pool.pop(0),
                                   amount=U128_MAX, ledger=0, code=0,
                                   flags=int(TF.post_pending_transfer)))
                elif i % 4 == 0:
                    batch.append(x(nid, dr, dr + 1, 3, flags=int(TF.pending),
                                   timeout=10))
                    made.append(nid)
                else:
                    batch.append(x(nid, dr, dr + 1, int(rng.integers(1, 99))))
                nid += 1
            if poison == k and b == w // 2:
                batch[-1] = x(batch[0].id, 1, 2, 1)
            ts += n + 10
            bodies.append(xfer_body(batch))
            tss.append(ts)
        out.append((bodies, tss))
        pool += made
    return out


def _window_pair(jax_engine="oracle"):
    pair = Pair("device", jax_engine)
    pair.commit(O.create_accounts, acct_body(_accounts21()), TS)
    return pair


def _commit_each(pair, window):
    return [pair.jax.commit(O.create_transfers, b, t)
            for b, t in zip(*window)]


@pytest.mark.parametrize("poison", [None, 1], ids=["clean", "poisoned"])
def test_commit_window_matches_per_body_commits(poison):
    """commit_window on the device engine: the replies of per-body
    commits on the JAX StateMachine, a window with a repeated id
    included (the chain's clean prefix, the replay per body); the
    metrics count every body."""
    pair = _window_pair()
    for window in _window_bodies(3, 3, poison=poison):
        got = pair.port.commit_window(TT.Operation.create_transfers, *window)
        assert got == _commit_each(pair, window)
    assert pair.port.led.window_routes.get("chain", 0) >= 1
    assert pair.port.metrics["create_transfers"]["count"] == 9
    assert (oracle_state_digest(pair.port.state, A_CAP)
            == device_state_digest(pair.port.led.state))


@pytest.mark.parametrize("engine", ["oracle", "kernel"])
def test_host_engines_commit_windows_per_body(engine):
    """On the host engines commit_window commits body by body, and
    all_or_nothing gives None."""
    pair = Pair(engine)
    pair.commit(O.create_accounts, acct_body(_accounts21()), TS)
    window = _window_bodies(4, 1, n=(8 if engine == "kernel" else 40))[0]
    assert pair.port.commit_window(TT.Operation.create_transfers, *window,
                                   all_or_nothing=True) is None
    got = pair.port.commit_window(TT.Operation.create_transfers, *window)
    assert got == _commit_each(pair, window)


def test_all_or_nothing_window_returns_none_with_the_state_untouched():
    """all_or_nothing=True on the device engine: a window that falls back
    (a repeated id) gives None and leaves the device state, the mirror
    and the metrics as they were, as the JAX device engine does; the
    caller then commits body by body. A clean window gives (replies,
    bodies' inner batch counts) equal to the JAX device engine's."""
    pair = _window_pair(jax_engine="device")
    op = TT.Operation.create_transfers
    clean, dup = _window_bodies(5, 2, poison=1)
    got = pair.port.commit_window(op, *clean, all_or_nothing=True)
    want = pair.jax.commit_window(O.create_transfers, *clean,
                                  all_or_nothing=True)
    assert got == want and got[1] == [1, 1, 1]
    before = (device_state_digest(pair.port.led.state),
              oracle_state_digest(pair.port.state, A_CAP),
              copy.deepcopy(pair.port.metrics))
    assert pair.port.commit_window(op, *dup, all_or_nothing=True) is None
    assert pair.jax.commit_window(O.create_transfers, *dup,
                                  all_or_nothing=True) is None
    assert before == (device_state_digest(pair.port.led.state),
                      oracle_state_digest(pair.port.state, A_CAP),
                      pair.port.metrics)
    for b, t in zip(*dup):
        pair.commit(O.create_transfers, b, t)
    assert pair.port.led.window_routes == pair.jax.led.window_routes
    assert pair.port.led.window_fallbacks == pair.jax.led.window_fallbacks


def _drive(sm, windows, stage):
    op = TT.Operation.create_transfers
    replies, in_flight = [], 0
    if stage:
        sm.stage_commit_window(op, *windows[0])
    for i, window in enumerate(windows):
        rec = sm.submit_commit_window(op, *window)
        if rec is None:
            replies.extend(r["replies"] for r in sm.resolve_commit_windows())
            in_flight = 0
            replies.append(sm.commit_window(op, *window))
            continue
        in_flight += 1
        if stage and i + 1 < len(windows):
            sm.stage_commit_window(op, *windows[i + 1])
        if in_flight > 1:
            done = sm.resolve_commit_windows(count=1)
            in_flight -= len(done)
            replies.extend(r["replies"] for r in done)
    replies.extend(r["replies"] for r in sm.resolve_commit_windows())
    return replies


@pytest.mark.parametrize("stage", [False, True], ids=["inline", "staged"])
@pytest.mark.parametrize("recycle", [False, True], ids=["ring", "recycle"])
@pytest.mark.parametrize("poison", [None, 2], ids=["clean", "poisoned"])
def test_pipelined_commit_windows_match(stage, recycle, poison):
    """stage_ / submit_ / resolve_commit_window[s] two deep (test_window_
    pipeline.py's and test_overlap_parity.py's loop): every window's
    replies equal per-body commits on the JAX StateMachine, the mirror
    equal to the device by digest; a staged pack is consumed by its own
    window only."""
    pair = _window_pair()
    pair.port.led.recycle_events = recycle
    windows = _window_bodies(6, 4, poison=poison)
    got = _drive(pair.port, windows, stage)
    assert got == [_commit_each(pair, w) for w in windows]
    led = pair.port.led
    assert (oracle_state_digest(pair.port.state, A_CAP)
            == device_state_digest(led.state))
    summary = led.staging_summary()
    if poison is None:
        assert summary["windows"] == 4 and summary["misses"] == 0
        assert summary["staged"] == (4 if stage else 0)
    if not stage:
        assert summary["host_stall_fraction"] in (None, 1.0)


def test_metrics_count_every_operation():
    """The metrics table counts each operation's commits as the JAX
    StateMachine's does."""
    pair = Pair("device")
    setup(pair)
    for op, body in queries()[:6]:
        pair.commit(op, body, TS + 300)
    assert ({k: v["count"] for k, v in pair.port.metrics.items()}
            == {k: v["count"] for k, v in pair.jax.metrics.items()})
    assert all(v["total_ns"] >= v["max_ns"] > 0
               for v in pair.port.metrics.values())


def test_restored_state_rebuilds_the_device():
    """Assigning .state (a restart's restored state) rebuilds the device
    ledger from it; serving goes on equal to the JAX StateMachine."""
    pair = Pair("device")
    setup(pair)
    restored = copy.deepcopy(pair.port.state)
    sm2 = port_sm("device")
    sm2.state = restored
    assert (device_state_digest(sm2.led.state)
            == device_state_digest(pair.port.led.state))
    pair.port = sm2
    pair.commit(O.create_transfers, xfer_body([
        x(106, 1, 3, 5), x(107, pending_id=104, amount=0, ledger=0, code=0,
                           flags=int(TF.void_pending_transfer))]), TS + 500)
    for op, body in queries():
        pair.commit(op, body, TS + 600)


def test_device_engine_hard_regime_and_probe_recovery():
    """test_device_engine.py's case: hard bodies (a repeated id) put the
    ledger in the mirror regime; MIRROR_PROBE_INTERVAL bodies later the
    probe returns it to the device tiers; every reply equal, the mirror
    equal to a rebuild from the device."""
    pair = Pair("device")
    pair.commit(O.create_accounts, acct_body(_accounts21()), TS)
    rng = np.random.default_rng(32)
    bodies = _random_bodies(rng, 12, 30, dup_rate=0)
    ts = TS + 1000
    for k, batches in enumerate(bodies):
        if k < 2:
            batches[0].append(dataclasses.replace(batches[0][0]))
        ts += sum(len(b) for b in batches) + 100
        pair.commit(O.create_transfers, xfer_body(*batches), ts)
    led = pair.port.led
    assert led.fallbacks > 0 and not led._hard_regime
    host = led.to_host()
    state = pair.port.state
    assert host.accounts == state.accounts
    assert host.transfers == state.transfers
    assert list(host.account_events) == list(state.account_events)


def test_the_card_is_the_default_device(monkeypatch):
    """StateMachine(device=None) and DeviceLedger(write_through=...,
    device=None) mean CUDA, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ENGINES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StateMachine(engine=engine)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceLedger(write_through=StateMachineOracle())
