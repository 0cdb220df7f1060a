"""The write-through ledger and its lazy mirror, port against the JAX
package, on the CPU.

Three kinds of check:

  - the lazy containers (`ops/lazy_mirror.py`) and the host digests
    (`ops/state_epoch.py`): the port's against the JAX package's on the
    same chunks and the same oracle states;
  - the write-through ledger one batch at a time: after every batch both
    mirrors drain, and the port's mirror must equal the JAX oracle's
    state exactly and the JAX write-through ledger's mirror (commit_ts
    aside on imported traffic, where the JAX package's device tiers keep
    the prepare timestamp), and its digest must equal the port ledger's
    device digest; over the plain, fixpoint, imported and balancing
    tiers, the mirror fallback and an expiry;
  - windows and the ring: windows synchronous and pipelined two deep,
    with recycle_events on and off, each prepare also on the JAX oracle;
    staged and unstaged packs byte-identical.

Inputs are made with numpy from a seed. Every JAX ledger batch is at
most 200 events (one pad bucket, 1024; one delta-gather bucket, 256), so
the JAX package compiles one program a tier.
"""

import copy
import dataclasses
import enum

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.oracle import StateMachineOracle as JOracle
from tigerbeetle_tpu.ops import lazy_mirror as JLM
from tigerbeetle_tpu.ops import ledger as JL
from tigerbeetle_tpu.ops import state_epoch as JSE
from tigerbeetle_tpu.ops.batch import transfers_to_arrays
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu_torch import DeviceLedger
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.oracle import StateMachineOracle as TOracle
from tigerbeetle_tpu_torch.ops import lazy_mirror as TLM
from tigerbeetle_tpu_torch.ops import ledger as TL
from tigerbeetle_tpu_torch.ops import state_epoch as TSE

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

A_CAP = 1 << 10
T_CAP = 1 << 13
N_ACC = 48
TS0 = 10**12
U128_MAX = (1 << 128) - 1
TF = JT.TransferFlags
AF = JT.AccountFlags


# ------------------------------------------------------------- helpers

def plain(x):
    """A comparable value of a port or JAX object: dataclasses as
    (class name, fields), enums as ints, lazy records built."""
    if hasattr(x, "_build") and not dataclasses.is_dataclass(x):
        x = x._build()
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                tuple(plain(getattr(x, f.name))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return int(x)
    return x


def state_of(sm, commit_ts=True) -> dict:
    """Everything an oracle state holds, comparable across packages."""
    out = dict(
        accounts={k: plain(v) for k, v in sm.accounts.items()},
        transfers={k: plain(v) for k, v in sm.transfers.items()},
        pending_status={k: int(v) for k, v in sm.pending_status.items()},
        expiry=dict(sm.expiry),
        orphaned=set(sm.orphaned),
        account_events=[plain(r) for r in sm.account_events],
        account_by_timestamp=dict(sm.account_by_timestamp),
        transfer_by_timestamp=dict(sm.transfer_by_timestamp),
        pulse_next=sm.pulse_next_timestamp,
        key_max=(sm.accounts_key_max, sm.transfers_key_max),
    )
    if commit_ts:
        out["commit_ts"] = sm.commit_timestamp
    return out


def port(obj):
    """A JAX Account / Transfer as the port's."""
    return getattr(TT, type(obj).__name__)(**dataclasses.asdict(obj))


def x(i, dr=0, cr=0, amount=0, ledger=1, code=1, **kw):
    return JT.Transfer(id=i, debit_account_id=dr, credit_account_id=cr,
                       amount=amount, ledger=ledger, code=code, **kw)


def accounts(imported=False):
    """Accounts 1..N_ACC on ledger 1: two limited ones, one closed, a
    few with history; imported at user timestamps when asked."""
    out = []
    for i in range(1, N_ACC + 1):
        flags = 0
        if i == N_ACC - 1:
            flags = AF.debits_must_not_exceed_credits
        elif i == N_ACC:
            flags = AF.closed
        elif i % 8 == 0:
            flags = AF.history
        a = JT.Account(id=i, ledger=1, code=1, flags=int(flags))
        if imported:
            a.flags |= AF.imported
            a.timestamp = 10**6 + i
        out.append(a)
    return out


def mixed(rng, first, n, pend_pool, kind="plain", ts_base=None):
    """n transfers of one kind over the accounts: uniform transfers,
    pendings (some with a 1 s timeout), posts and voids of committed
    pendings, not-found and closed-account failures; 'fixpoint' adds
    debits of the limited account, 'imported' imports every event at
    user timestamps after ts_base, 'balancing' adds balancing debits."""
    out = []
    for i in range(n):
        tid = first + i
        dr = int(rng.integers(1, N_ACC - 1))
        cr = dr % (N_ACC - 2) + 1
        roll = rng.random()
        if kind != "imported" and roll < 0.15 and pend_pool:
            pid = pend_pool.pop(0)
            post = rng.random() < 0.5
            out.append(x(tid, pending_id=pid,
                         amount=U128_MAX if post else 0, ledger=0, code=0,
                         flags=int(TF.post_pending_transfer if post
                                   else TF.void_pending_transfer)))
        elif roll < 0.35:
            out.append(x(tid, dr, cr, int(rng.integers(1, 100)),
                         flags=int(TF.pending),
                         timeout=int(rng.integers(0, 2))
                         if kind != "imported" else 0))
        elif roll < 0.4:
            out.append(x(tid, 10**6 + i, cr, 5))            # not found
        elif roll < 0.43 and kind != "imported":
            out.append(x(tid, dr, N_ACC, 5))                 # closed
        elif kind == "fixpoint" and roll < 0.6:
            out.append(x(tid, N_ACC - 1, cr, int(rng.integers(1, 30))))
        elif kind == "balancing" and roll < 0.55:
            out.append(x(tid, N_ACC - 1, cr, 10**9,
                         flags=int(TF.balancing_debit)))
        else:
            out.append(x(tid, dr, cr, int(rng.integers(0, 1000))))
    if kind == "imported":
        for k, t in enumerate(out):
            t.flags |= int(TF.imported)
            t.timestamp = ts_base + 1 + k
    return out


def note_pendings(batch, results, pend_pool):
    for t, (st, _) in zip(batch, results):
        if int(st) == int(JT.CreateTransferStatus.created) and (
                t.flags & TF.pending):
            pend_pool.append(t.id)


class WT:
    """The port's write-through ledger (CPU), the JAX package's and the
    JAX oracle, fed the same traffic."""

    def __init__(self, jax_ledger=True, imported=False):
        self.mirror = TOracle()
        self.port = DeviceLedger(A_CAP, T_CAP, write_through=self.mirror,
                                 device="cpu")
        self.jmirror = JOracle() if jax_ledger else None
        self.jax = (JL.DeviceLedger(A_CAP, T_CAP, write_through=self.jmirror)
                    if jax_ledger else None)
        self.sm = JOracle()
        self.ts = TS0
        self.imported = False
        accts = accounts(imported)
        self.ts += 100
        self.port.create_accounts([port(a) for a in accts], self.ts)
        if self.jax is not None:
            self.jax.create_accounts(accts, self.ts)
        self.sm.create_accounts(accts, self.ts)
        self.imported = imported
        self.check()

    def batch(self, transfers, mirror=False):
        """One batch; returns its (status, timestamp) pairs."""
        self.ts += len(transfers) + 100
        fb = self.port.fallbacks
        ev = transfers_to_arrays(transfers)
        got = self.port.create_transfers_soa(ev, self.ts)
        want = [(int(r.status), r.timestamp)
                for r in self.sm.create_transfers(transfers, self.ts)]
        assert list(zip(got[0].tolist(), got[1].tolist())) == want
        if self.jax is not None:
            ref = self.jax.create_transfers_soa(ev, self.ts)
            assert list(zip(ref[0].tolist(), ref[1].tolist())) == want
        assert (self.port.fallbacks > fb) == mirror
        if any(t.flags & TF.imported for t in transfers):
            self.imported = True
        self.check()
        return want

    def check(self):
        self.port.drain_mirror()
        want = state_of(self.sm)
        assert state_of(self.mirror) == want
        if self.jax is not None:
            self.jax.drain_mirror()
            assert (state_of(self.mirror, commit_ts=not self.imported)
                    == state_of(self.jmirror, commit_ts=not self.imported))
            assert _counters(self.port) == _counters(self.jax)
        digest = TSE.oracle_state_digest(self.mirror, A_CAP)
        assert digest == TSE.device_state_digest(self.port.state)
        assert digest == JSE.oracle_state_digest(self.sm, A_CAP)


def _counters(led):
    return (led.fast_batches, led.fixpoint_batches,
            led.deep_fixpoint_batches, led.escalations, led.fallbacks,
            dict(led.fallback_causes))


# ------------------------------------------- lazy containers and digests

@pytest.fixture(scope="module")
def chunks():
    """Chunks of the port's write-through ledger over two mixed batches:
    (columns, the JAX oracle after the batch, its copy before it)."""
    wt = WT(jax_ledger=False)
    rng = np.random.default_rng(5)
    pool, out, nid = [], [], 10**5
    for _ in range(3):
        batch = mixed(rng, nid, 150, pool)
        nid += 150
        before = copy.deepcopy(wt.sm)
        wt.ts += len(batch) + 100
        got = wt.port.create_transfers_soa(transfers_to_arrays(batch), wt.ts)
        want = wt.sm.create_transfers(batch, wt.ts)
        note_pendings(batch, [(r.status, 0) for r in want], pool)
        assert got[0].tolist() == [int(r.status) for r in want]
        t, e, der = wt.port._mirror_chunks[-1][:3]
        out.append(({k: v.copy() for k, v in t.items()},
                    {k: v.copy() for k, v in e.items()},
                    {k: v.copy() for k, v in der.items()},
                    copy.deepcopy(wt.sm), before))
        wt.check()
    return out


def test_lazy_chunks_match_the_jax_package(chunks):
    """DeltaChunk: every transfer, account snapshot and event record of
    each chunk built by the port equals the JAX package's, on the same
    columns and the same state; the columns carry the JAX dtypes."""
    for t, e, der, after, _ in chunks:
        for cols, want in ((t, "t"), (e, "e")):
            for k, v in cols.items():
                assert v.dtype in (np.uint64, np.uint32, np.int32), (want, k)
        n = len(t["id_lo"])
        ids = [(int(h) << 64) | int(lo)
               for h, lo in zip(t["id_hi"], t["id_lo"])]
        mirror = TOracle()
        for a in after.accounts.values():
            mirror.accounts[a.id] = port(a)
        for tid, tr in after.transfers.items():
            mirror.transfers[tid] = port(tr)
        mirror.transfer_by_timestamp.update(after.transfer_by_timestamp)
        tc = TLM.DeltaChunk(t, e, der, mirror, ids)
        jc = JLM.DeltaChunk(t, e, der, after, ids)
        for k in range(n):
            assert plain(tc.transfer(k)) == plain(jc.transfer(k))
            for side in ("dr", "cr"):
                assert plain(tc.account(side, k)) == plain(jc.account(side, k))
            assert plain(tc.event(k)) == plain(jc.event(k))
            assert plain(tc.event(k)) == plain(after.account_events[
                len(after.account_events) - n + k])


def test_apply_account_finals_matches_the_jax_package(chunks):
    """The vectorized last-writer pass: the same changed ids and the same
    final accounts as the JAX package's, and as the oracle after the
    batch."""
    for _, e, der, after, before in chunks:
        jb = copy.deepcopy(before)
        tb = TOracle()
        for a in before.accounts.values():
            tb.accounts[a.id] = port(a)
        assert (TLM.apply_account_finals(tb, e, der)
                == JLM.apply_account_finals(jb, e, der))
        assert ({k: plain(v) for k, v in tb.accounts.items()}
                == {k: plain(v) for k, v in jb.accounts.items()}
                == {k: plain(v) for k, v in after.accounts.items()})


@pytest.mark.parametrize("impl", [TLM, JLM], ids=["port", "jax"])
def test_lazy_event_list_surface(impl):
    """The JAX package's surface test, on both packages' lists."""
    lst = impl.LazyEventList()
    assert not lst and len(lst) == 0 and lst == []

    class _FakeChunk:
        def event(self, k):
            return ("ev", k)

    c = _FakeChunk()
    lst.extend_lazy(c, 5)
    lst.append("real-0")
    lst.extend_lazy(c, 3)
    assert len(lst) == 9
    assert lst[5] == "real-0"
    assert isinstance(lst[0], impl.LazyEventRecord)
    del lst[:2]
    assert len(lst) == 7
    assert lst[3] == "real-0"
    del lst[6:]
    assert len(lst) == 6
    items = list(lst)
    assert items[3] == "real-0" and len(items) == 6
    assert [r._build() if hasattr(r, "_k") else r for r in lst[1:4]] == [
        ("ev", 3), ("ev", 4), "real-0"]


def test_lazy_transfer_dict_mutation_semantics():
    """Point reads materialize one row without dirtying; pop and del of a
    lazy row mark both channels; reinsertion is a plain DirtyDict write;
    equality materializes everything. The port's dict and the JAX
    package's behave alike on the same chunk."""
    wt = WT(jax_ledger=False)
    batch = mixed(np.random.default_rng(9), 10**5, 120, [])
    wt.ts += 220
    wt.port.create_transfers_soa(transfers_to_arrays(batch), wt.ts)
    wt.sm.create_transfers(batch, wt.ts)
    wt.port.drain_mirror()
    ref = wt.sm.transfers
    transfers = wt.mirror.transfers
    assert isinstance(transfers, TLM.LazyTransferDict)
    assert transfers._lazy
    lazy_before = len(transfers._lazy)
    some = next(iter(transfers._lazy))
    dirty_dev = set(transfers.dirty_dev)
    assert plain(transfers[some]) == plain(ref[some])
    assert len(transfers._lazy) == lazy_before - 1
    assert transfers.dirty_dev == dirty_dev
    other = next(iter(transfers._lazy))
    assert other in transfers and other in set(transfers.keys())
    n = len(transfers)
    transfers.dirty.discard(other)
    popped = transfers.pop(other)
    assert plain(popped) == plain(ref[other])
    assert other in transfers.dirty and other in transfers.dirty_dev
    assert len(transfers) == n - 1 and other not in transfers
    transfers[other] = popped
    del transfers[other]
    assert other not in transfers
    transfers[other] = popped
    transfers.dirty_dev.clear()
    assert {k: plain(v) for k, v in transfers.items()} == {
        k: plain(v) for k, v in ref.items()}
    assert not transfers._lazy


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_host_digests_match_the_jax_package(seed):
    """pack_oracle_state, oracle_state_digest, combine and
    diverging_components of the port's oracle state equal the JAX
    package's of the JAX oracle fed the same traffic (an expiry
    included)."""
    rng = np.random.default_rng(seed)
    sms = (TOracle(), JOracle())
    accts = accounts()
    sms[0].create_accounts([port(a) for a in accts], TS0)
    sms[1].create_accounts(accts, TS0)
    pool, ts = [], TS0 + 1000
    for b in range(3):
        batch = mixed(rng, 10**5 + 1000 * b, 80, pool,
                      kind=("plain", "fixpoint", "balancing")[b])
        ts += 10**9
        r0 = sms[0].create_transfers([port(t) for t in batch], ts)
        r1 = sms[1].create_transfers(batch, ts)
        assert [plain(r) for r in r0] == [plain(r) for r in r1]
        note_pendings(batch, [(r.status, 0) for r in r1], pool)
    assert sms[0].expire_pending_transfers(ts + 2 * 10**9) == \
        sms[1].expire_pending_transfers(ts + 2 * 10**9)
    p0 = TSE.pack_oracle_state(sms[0], A_CAP)
    p1 = JSE.pack_oracle_state(sms[1], A_CAP)
    for store in ("accounts", "transfers"):
        for k in p1[store]:
            np.testing.assert_array_equal(p0[store][k], p1[store][k])
    for k in ("acct_key_max", "xfer_key_max", "commit_ts"):
        assert int(p0[k]) == int(p1[k])
    d0 = TSE.oracle_state_digest(sms[0], A_CAP)
    d1 = JSE.oracle_state_digest(sms[1], A_CAP)
    assert d0 == d1
    assert TSE.combine(d0) == JSE.combine(d1)
    bent = dict(d1, transfers_u64=d1["transfers_u64"] ^ 1)
    assert (TSE.diverging_components(d0, bent)
            == JSE.diverging_components(d1, bent) == ["transfers_u64"])
    assert TSE.diverging_components(d0, d1) == []


# ---------------------------------------------- the write-through ledger

@pytest.mark.parametrize("kind", ["plain", "fixpoint", "imported",
                                  "balancing"])
def test_write_through_ledger_matches_the_jax_ledger_and_the_oracle(kind):
    """Batches of one kind on the port's write-through ledger, the JAX
    package's and the JAX oracle; after every batch the port's drained
    mirror equals the oracle (accounts, transfers, pending status,
    expiry, orphans, account_events, the by-timestamp maps, the
    scalars), the JAX mirror (commit_ts aside on imported traffic) and,
    by digest, the port ledger's device state; the counters equal the
    JAX ledger's."""
    wt = WT(imported=kind == "imported")
    rng = np.random.default_rng({"plain": 11, "fixpoint": 12,
                                 "imported": 13, "balancing": 14}[kind])
    pool, nid = [], 10**5
    for _ in range(3):
        batch = mixed(rng, nid, 160, pool, kind=kind, ts_base=wt.ts + 10)
        nid += 160
        note_pendings(batch, wt.batch(batch), pool)
    led = wt.port
    if kind == "fixpoint":
        assert led.fixpoint_batches > 0
    if kind == "balancing":
        assert led.fixpoint_batches == 3
    assert led.fallbacks == 0


def test_mirror_fallback_and_probe_recovery():
    """A repeated id sends a batch to the mirror: a write-through ledger
    runs it on its permanent mirror (no to_host) and pushes what it
    dirtied; MIRROR_PROBE_INTERVAL batches later the device tiers take
    the traffic back, the mirror exact throughout, equal to the JAX
    write-through ledger's."""
    wt = WT()
    rng = np.random.default_rng(21)
    pool, nid = [], 10**5
    led = wt.port
    led.to_host = None     # a write-through ledger never rebuilds
    for b in range(led.MIRROR_PROBE_INTERVAL + 3):
        batch = mixed(rng, nid, 60, pool)
        nid += 60
        if b == 0:
            batch.append(dataclasses.replace(batch[0]))
        note_pendings(batch, wt.batch(
            batch, mirror=b < led.MIRROR_PROBE_INTERVAL), pool)
    assert led.fallbacks == led.MIRROR_PROBE_INTERVAL
    assert not led._hard_regime
    assert led.mirror is wt.mirror


def test_fast_orphans_are_not_pushed_back():
    """Transient failures on a device tier insert orphan ids on the
    card; the drain mirrors them on the host (the durable channel keeps
    them, the device channel does not), so the next hard batch's push
    does not insert them twice, and a retry reports id_already_failed."""
    wt = WT()
    led = wt.port
    ids = [10**5 + i for i in range(10)]
    wt.batch([x(i, 500 + i, 1, 1) for i in ids])
    assert all(o in wt.mirror.orphaned for o in ids)
    assert not wt.mirror.orphaned.dirty_dev
    assert set(ids) <= wt.mirror.orphaned.dirty
    hard = [x(10**5 + 100, 1, 2, 1), x(10**5 + 100, 1, 2, 1)]
    wt.batch(hard, mirror=True)
    got = wt.batch([x(ids[0], 1, 2, 1)], mirror=True)
    assert got[0][0] == int(JT.CreateTransferStatus.id_already_failed)


def test_expiry_pulse_through_the_mirror():
    """Pendings with a 1 s timeout, then the pulse past it: the expiry
    runs on the write-through mirror and is pushed to the card, equal to
    the JAX ledger's and the oracle's."""
    wt = WT()
    wt.batch([x(10**5 + i, 1 + i, 2 + i, 10, flags=int(TF.pending),
                timeout=1) for i in range(5)])
    later = wt.ts + 5 * 10**9
    assert wt.port.pulse_needed(later) and wt.jax.pulse_needed(later)
    assert (wt.port.expire_pending_transfers(later)
            == wt.jax.expire_pending_transfers(later)
            == wt.sm.expire_pending_transfers(later) == 5)
    wt.check()
    assert not wt.port.pulse_needed(later)


def test_restored_state_rebuilds_the_device():
    """A write-through ledger over a restored (non-empty) oracle state
    rebuilds its device tables from it and serves on from there."""
    wt = WT(jax_ledger=False)
    rng = np.random.default_rng(23)
    pool = []
    wt.batch(mixed(rng, 10**5, 100, pool))
    restored = copy.deepcopy(wt.mirror)
    led = DeviceLedger(A_CAP, T_CAP, write_through=restored, device="cpu")
    assert (TSE.device_state_digest(led.state)
            == TSE.device_state_digest(wt.port.state))
    wt.port, wt.mirror = led, restored
    wt.batch(mixed(rng, 2 * 10**5, 100, pool))
    host = led.to_host()
    assert state_of(host) == state_of(restored)


def test_accounts_batch_writes_through():
    """A device accounts batch reaches the mirror with its timestamps,
    key maximum and commit timestamp; an imported one too."""
    wt = WT(jax_ledger=False)
    more = [JT.Account(id=1000 + i, ledger=1, code=1) for i in range(5)]
    wt.ts += 100
    wt.port.create_accounts([port(a) for a in more], wt.ts)
    wt.sm.create_accounts(more, wt.ts)
    wt.check()
    assert wt.port.fast_batches == 2


# ------------------------------------------------------ windows and ring

def _window_traffic(seed, n_windows, w=3, n=50, poison=None):
    """n_windows windows of w prepares: uniform transfers and pendings,
    posts of earlier windows' pendings; a repeated id in the middle
    prepare of window `poison`."""
    rng = np.random.default_rng(seed)
    out, nid, ts, pool = [], 10**6, TS0 + 10**6, []
    for k in range(n_windows):
        batches, tss = [], []
        for b in range(w):
            batch = []
            for i in range(n):
                dr = int(rng.integers(1, N_ACC - 2))
                if i % 5 == 0 and pool:
                    batch.append(x(nid, pending_id=pool.pop(0),
                                   amount=U128_MAX, ledger=0, code=0,
                                   flags=int(TF.post_pending_transfer)))
                elif i % 4 == 0:
                    batch.append(x(nid, dr, dr + 1, 3, flags=int(TF.pending),
                                   timeout=10))
                else:
                    batch.append(x(nid, dr, dr + 1, int(rng.integers(1, 99))))
                nid += 1
            if poison == k and b == w // 2:
                batch[-1] = x(batch[0].id, 1, 2, 1)
            ts += n + 10
            batches.append(batch)
            tss.append(ts)
        out.append((batches, tss))
        pool += [t.id for bt in batches for t in bt if t.flags & TF.pending]
    return out


def _drive(led, windows, pipelined, stage):
    evss = [[transfers_to_arrays(b) for b in batches]
            for batches, _ in windows]
    results = []
    if not pipelined:
        for evs, (_, tss) in zip(evss, windows):
            results.append(led.create_transfers_window(evs, tss))
        return results
    pending = []
    if stage:
        led.stage_window(evss[0], windows[0][1])
    for i, (evs, (_, tss)) in enumerate(zip(evss, windows)):
        tk = led.submit_window(evs, tss)
        if tk is None:
            led.resolve_windows()
            results.extend(p.results[1] for p in pending)
            pending = []
            results.append(led.create_transfers_window(evs, tss))
            continue
        pending.append(tk)
        if stage and i + 1 < len(windows):
            led.stage_window(evss[i + 1], windows[i + 1][1])
        if len(pending) > 1:
            led.resolve_windows(count=1)
            while pending and pending[0].results is not None:
                results.append(pending.pop(0).results[1])
    led.resolve_windows()
    results.extend(p.results[1] for p in pending)
    return results


@pytest.mark.parametrize("pipelined,stage", [(False, False), (True, False),
                                             (True, True)],
                         ids=["sync", "pipelined", "staged"])
@pytest.mark.parametrize("recycle", [False, True], ids=["ring", "recycle"])
@pytest.mark.parametrize("poison", [None, 1], ids=["clean", "poisoned"])
def test_windows_write_through(pipelined, stage, recycle, poison):
    """Windows of 3 prepares on the write-through ledger, synchronous or
    two deep (staged or not), the event ring kept or recycled, one
    window with a repeated id or none: every prepare's results equal the
    JAX oracle's, the drained mirror equals the oracle's state, its
    digest the device's; with recycle_events the ring's count is 0 after
    every window and the pipelined windows ran the ring kernels."""
    wt = WT(jax_ledger=False)
    led = wt.port
    led.recycle_events = recycle
    windows = _window_traffic(31, 4, poison=poison)
    got = _drive(led, windows, pipelined, stage)
    want = [[[(int(r.status), r.timestamp)
              for r in wt.sm.create_transfers(b, t)]
             for b, t in zip(batches, tss)] for batches, tss in windows]
    assert [[list(zip(st.tolist(), ts.tolist())) for st, ts in w]
            for w in got] == want
    wt.check()
    if recycle:
        assert int(led.state["events"]["count"]) == 0
        assert led._events_pushed == 0
        if pipelined:
            assert any(len(k) == 4 and k[3] == "ring"
                       for k in led.windows.eager)
    if pipelined and poison is None:
        assert led.staging_stats["windows"] == 4
        assert led.staging_stats["staged"] == (4 if stage else 0)
    assert (led.fallbacks > 0) == (poison is not None)


def test_staged_and_inline_packs_are_identical():
    """stage_window packs on the stager thread exactly the bytes
    submit_window would pack inline; the stage is consumed only by the
    same window (identity of its prepare dicts, its timestamps), a miss
    packs inline; shutdown_staging stops the stager."""
    wt = WT(jax_ledger=False)
    led = wt.port
    (b0, t0), (b1, t1) = _window_traffic(41, 2)
    evs0 = [transfers_to_arrays(b) for b in b0]
    evs1 = [transfers_to_arrays(b) for b in b1]
    assert led.stage_window(evs0, t0)
    assert led.staged_matches(evs0, t0)
    assert not led.staged_matches([dict(e) for e in evs0], t0)
    route, n_pad = led._window_plan(evs0)
    staged = led._consume_staged(evs0, t0, route, n_pad)
    inline, _ = led._pack_window(route, evs0, t0, n_pad)
    assert staged is not None
    assert torch.equal(staged, inline)
    # A stage of another window is a miss: submit packs inline.
    assert led.stage_window(evs1, t1)
    tk = led.submit_window(evs0, t0)
    assert led.staging_stats["misses"] == 1
    led.resolve_windows()
    assert tk.results[0] == "ok"
    assert led.stage_window(evs1, t1)
    led.submit_window(evs1, t1)
    led.resolve_windows()
    assert led.staging_summary()["staged"] == 2
    led.shutdown_staging()
    assert led._stager is None and led._staged is None
    led.overlap_staging = False
    assert not led.stage_window(evs1, t1)
    for batches, tss in ((b0, t0), (b1, t1)):
        for b, t in zip(batches, tss):
            wt.sm.create_transfers(b, t)
    wt.check()


def test_synthesized_columns_equal_the_device_rows():
    """A window with no post/void, imported or balancing flag fetches
    its event rows only: the transfer and derived columns the host
    synthesizes from its inputs equal the device's rows bit for bit (the
    device-internal row indices aside)."""
    wt = WT(jax_ledger=False)
    led = wt.port
    rng = np.random.default_rng(51)
    batches = [mixed(rng, 10**5 + 200 * b, 60, []) for b in range(2)]
    tss = [wt.ts + 1000, wt.ts + 2000]
    evs = [transfers_to_arrays(b) for b in batches]
    res = led.create_transfers_window(evs, tss)
    chunks = led._mirror_chunks
    assert len(chunks) == 2
    total = sum(c[4] for c in chunks)
    h = TL._DeltaFetchHandle(TL._delta_gather_body(
        led.state, chunks[0][3], led._events_pushed - total, total, total),
        chunks[0][3], 0, 0)
    off = 0
    for (tc, ec, derc, *_rest), (st, _), ev, ts in zip(chunks, res, evs,
                                                       tss):
        assert isinstance(tc, TL._SynthCols)
        n = int((st == TL._CREATED).sum())
        dev_t = h.slice_cols("t", off, n)
        dev_d = h.slice_cols("der", off, n)
        for k, v in tc.items():
            if k not in ("dr_row", "cr_row"):
                np.testing.assert_array_equal(v, dev_t[k], err_msg=k)
                assert v.dtype == dev_t[k].dtype, k
        for k in TL._DER_KEYS[:4]:
            np.testing.assert_array_equal(derc[k], dev_d[k], err_msg=k)
        off += n
    for b, t in zip(batches, tss):
        wt.sm.create_transfers(b, t)
    wt.ts = tss[-1]
    wt.check()
