"""The durable path of the port against the JAX package's, on the CPU.

A replica's commit loop minus consensus runs twice on the same wire
bodies made from a numpy seed: the port's `StateMachine(engine="device",
device="cpu")` and the JAX package's `StateMachine(engine="device")`,
each with its own `DurableState` on a `MemoryStorage(TEST_LAYOUT)` (the
port's on a `FileStorage` in a temporary directory where a case
restarts it). After every op both take the replica's flush policy
(`vsr/replica.py` `_post_commit`): the ledger's flush columns, one
prepare's worth in a window, through the column path when the mirror is
quiescent, else a drain and the object path; then the cache upsert and
one compaction beat. Every CHECKPOINT_INTERVAL ops both checkpoint, write
the root to the other snapshot slot and flip the superblock.

Held: every reply byte for byte; after every checkpoint the grid zones,
the roots, the snapshot zones and the superblocks byte for byte, through
single bodies, all_or_nothing windows (an empty prepare among them),
pipelined windows two deep, a hard body on the mirror, a pulse past
pending timeouts, a bar boundary, and u64 fields >= 2^63. Reads served
from the forest (lookups, the five queries) byte for byte, VERIFY's
cache-against-tree check included. The column flush against the object
flush, the hard-body interleave and the cache invalidation, as the JAX
package's tests/test_durable.py holds them. A restart from the data
file: the reopened state's digest equals the one before, and later
replies equal the JAX package's, whose replica never restarted.

The JAX side compiles its programs at one pad bucket (1024 lanes).
"""

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import constants as JC
from tigerbeetle_tpu import multi_batch as JMB
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu.ops.batch import TRANSFER_WIRE
from tigerbeetle_tpu.state_machine import StateMachine as JSM
from tigerbeetle_tpu.vsr import durable as JD
from tigerbeetle_tpu.vsr import storage as JS
from tigerbeetle_tpu.vsr import superblock as JSB
from tigerbeetle_tpu.vsr.checksum import checksum as jchecksum
from tigerbeetle_tpu_torch import StateMachine
from tigerbeetle_tpu_torch import constants as TC
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.ops.state_epoch import device_state_digest
from tigerbeetle_tpu_torch.vsr import durable as TD
from tigerbeetle_tpu_torch.vsr import storage as TS
from tigerbeetle_tpu_torch.vsr import superblock as TSB
from tigerbeetle_tpu_torch.vsr.checksum import checksum as tchecksum

torch.set_num_threads(1)

A_CAP = 1 << 10
T_CAP = 1 << 14
N_ACCOUNTS = 48
BODY = 200
CHECKPOINT_INTERVAL = 8
O = JT.Operation
TF = JT.TransferFlags
AF = JT.AccountFlags


class Node:
    """One replica's state machine and data file: `port` picks the
    package. The JAX node's storage is a MemoryStorage; the port's is
    one too, or a FileStorage at `path`."""

    def __init__(self, port: bool, engine: str = "device", path=None):
        self.port = port
        self.D, self.S, self.SB = (TD, TS, TSB) if port else (JD, JS, JSB)
        self.checksum = tchecksum if port else jchecksum
        if port:
            self.sm = StateMachine(engine, a_cap=A_CAP, t_cap=T_CAP,
                                   device="cpu")
        else:
            self.sm = JSM(engine=engine, a_cap=A_CAP, t_cap=T_CAP)
        self.storage = (self.S.FileStorage(path, self.S.TEST_LAYOUT,
                                           create=True)
                        if path is not None
                        else self.S.MemoryStorage(self.S.TEST_LAYOUT))
        self.durable = self.D.DurableState(self.storage)
        self.sm.attach_durable(self.durable)
        self.op = 0
        self.paths = {"columns": 0, "object": 0}
        self.roots = []
        # Format: an empty forest root in snapshot slot 0 and the genesis
        # superblock (the storage part of the replica's format).
        root = self.D.DurableState(self.storage).checkpoint(
            self._empty_state())
        self.storage.write("snapshot", 0, root)
        self.sb = self.SB.SuperBlock(
            cluster=7, replica_id=0, replica_count=1, snapshot_slot=0,
            snapshot_size=len(root),
            snapshot_checksum=self.checksum(root, domain=b"ckptroot"))
        self.sb.store(self.storage)

    def _empty_state(self):
        if self.port:
            return StateMachine("oracle", device="cpu").state
        return JSM(engine="oracle").state

    def op_name(self, op):
        return (TT.Operation(int(op)) if self.port else op)

    # ------------------------------------------------- the commit loop

    def post_commit(self, chunk_count=None) -> None:
        """The replica's flush policy, beat and checkpoint trigger."""
        self.op += 1
        sm, led = self.sm, self.sm.led
        cols = (led.take_flush_columns(chunk_count) if led is not None
                else None)
        raw = sm.raw_state
        if cols and not self.D.mirror_quiescent(
                raw, self.durable.events_persisted):
            assert chunk_count is None, "a window met a dirty mirror"
            sm.state  # drains; the columns are stale now
            cols = None
        self.paths["columns" if cols else "object"] += 1
        sm.cache_upsert(*self.durable.flush(raw, flush_columns=cols))
        self.durable.compact_beat(self.op)
        if self.op % CHECKPOINT_INTERVAL == 0:
            self.checkpoint()

    def checkpoint(self) -> None:
        state = self.sm.state
        if self.sm.led is not None:
            self.sm.led.take_flush_columns()
        root = self.durable.checkpoint(state)
        lay = self.storage.layout
        slot = 1 - self.sb.snapshot_slot
        self.storage.write("snapshot", slot * lay.snapshot_size_max, root)
        self.sb.snapshot_slot = slot
        self.sb.snapshot_size = len(root)
        self.sb.snapshot_checksum = self.checksum(root, domain=b"ckptroot")
        self.sb.op_checkpoint = self.sb.commit_min = self.op
        self.sb.store(self.storage)
        self.roots.append(root)

    def commit(self, op, body: bytes, ts: int) -> bytes:
        reply = self.sm.commit(self.op_name(op), body, ts)
        self.post_commit()
        return reply

    def commit_window(self, bodies, tss) -> list:
        out = self.sm.commit_window(self.op_name(O.create_transfers),
                                    bodies, tss, all_or_nothing=True)
        if out is None:
            return [self.commit(O.create_transfers, b, t)
                    for b, t in zip(bodies, tss)]
        replies, shape = out
        for k in shape:
            self.post_commit(k)
        return replies

    def pipelined(self, windows) -> list:
        """Windows submitted two deep; each op's flush after its window
        resolves (every prepare of these windows creates rows, so a
        prepare's entries are its shape)."""
        op = self.op_name(O.create_transfers)
        replies, pending = [], []

        def finish(recs):
            for rec in recs:
                for reply, k in zip(rec["replies"], rec["shape"]):
                    replies.append(reply)
                    self.post_commit(k)

        for bodies, tss in windows:
            rec = self.sm.submit_commit_window(op, bodies, tss)
            assert rec is not None
            pending.append(rec)
            if len(pending) > 1:
                finish(self.sm.resolve_commit_windows(count=1))
                pending.pop(0)
        finish(self.sm.resolve_commit_windows())
        return replies

    # ---------------------------------------------------------- bytes

    def file_bytes(self) -> tuple:
        lay = self.storage.layout
        return (self.storage.read("grid", 0, lay.grid_block_count
                                  * lay.grid_block_size),
                self.storage.read("snapshot", 0, 2 * lay.snapshot_size_max),
                self.storage.read("superblock", 0, 4 * 4096))


class Pair:
    """The port's node and the JAX package's, fed the same bodies."""

    def __init__(self, engine="device", path=None):
        self.port = Node(True, engine, path)
        self.jax = Node(False, engine)
        self.checked = 0

    def same_files(self, where) -> None:
        assert self.port.roots == self.jax.roots, where
        got, want = self.port.file_bytes(), self.jax.file_bytes()
        for name, g, w in zip(("grid", "snapshot", "superblock"), got, want):
            assert g == w, f"{where}: the {name} zones differ"
        self.checked += 1

    def _after(self, n_ckpt) -> None:
        if len(self.jax.roots) > n_ckpt:
            self.same_files(f"checkpoint at op {self.jax.op}")

    def commit(self, op, body, ts) -> bytes:
        n = len(self.jax.roots)
        want = self.jax.commit(op, body, ts)
        got = self.port.commit(op, body, ts)
        assert got == want, (op, ts)
        self._after(n)
        return got

    def commit_window(self, bodies, tss) -> None:
        n = len(self.jax.roots)
        want = self.jax.commit_window(bodies, tss)
        assert self.port.commit_window(bodies, tss) == want
        self._after(n)

    def pipelined(self, windows) -> None:
        n = len(self.jax.roots)
        want = self.jax.pipelined(windows)
        assert self.port.pipelined(windows) == want
        self._after(n)


# -------------------------------------------------------------- traffic

class Traffic:
    """Wire bodies from a numpy seed: config-2-like transfers over
    N_ACCOUNTS accounts with u64 fields >= 2^63, pendings with timeouts,
    failing lanes, posts and voids of earlier pendings."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.next_id = (1 << 64) + 10**6  # an id_hi limb in every id
        self.ts = 10**12
        self.pending: list = []

    def next_ts(self, n: int) -> int:
        self.ts += n + 1000
        return self.ts

    def accounts(self) -> bytes:
        accts = [JT.Account(id=i, ledger=1, code=1 + i % 3,
                            user_data_64=(1 << 63) + i,
                            user_data_128=(1 << 127) | i,
                            flags=int(AF.history) if i % 4 == 0 else 0)
                 for i in range(1, N_ACCOUNTS + 1)]
        return JMB.encode([b"".join(a.pack() for a in accts)], 128)

    def _records(self, n: int):
        rng = self.rng
        rec = np.zeros(n, dtype=TRANSFER_WIRE)
        ids = self.next_id + np.arange(n, dtype=object)
        self.next_id += n
        rec["id_lo"] = [int(i) & (2**64 - 1) for i in ids]
        rec["id_hi"] = [int(i) >> 64 for i in ids]
        dr = rng.integers(1, N_ACCOUNTS + 1, n)
        rec["dr_lo"] = dr
        rec["cr_lo"] = dr % N_ACCOUNTS + 1
        rec["amt_lo"] = rng.integers(1, 1000, n)
        rec["ud128_lo"] = rng.integers(0, 2**63, n).astype(np.uint64)
        rec["ud128_hi"] = (rng.integers(0, 2**62, n).astype(np.uint64)
                           | np.uint64(1 << 63))
        rec["ud64"] = (rng.integers(0, 4, n).astype(np.uint64)
                       | np.uint64(1 << 63))
        rec["ud32"] = rng.integers(0, 5, n)
        rec["ledger"] = 1
        rec["code"] = rng.integers(1, 4, n)
        return rec

    def plain(self, n: int = BODY, pend_every: int = 5,
              fail: bool = True) -> bytes:
        rec = self._records(n)
        pend = np.arange(n) % pend_every == 1
        rec["flags"][pend] = int(TF.pending)
        rec["timeout"][pend] = np.where(np.arange(n)[pend] % 2, 1, 0)
        if fail:
            # A missing debit account (transient: the id is poisoned) and
            # equal accounts (not transient).
            rec["dr_lo"][7::25] = 999
            rec["cr_lo"][11::30] = rec["dr_lo"][11::30]
        for i in np.nonzero(pend)[0]:
            if rec["dr_lo"][i] != 999 and rec["cr_lo"][i] != rec["dr_lo"][i]:
                self.pending.append((int(rec["id_hi"][i]) << 64)
                                    | int(rec["id_lo"][i]))
        return JMB.encode([rec.tobytes()], 128)

    def resolve(self, n: int = 40) -> bytes:
        """Posts and voids of the oldest pendings, the full amount."""
        take, self.pending = self.pending[:n], self.pending[n:]
        rec = self._records(len(take))
        for f in ("dr_lo", "cr_lo", "amt_lo", "ud128_lo", "ud128_hi",
                  "ud64", "ud32", "code", "ledger"):
            rec[f] = 0
        void = np.arange(len(take)) % 3 == 0
        # The full amount: 0 for a void, AMOUNT_MAX for a post.
        rec["amt_lo"] = rec["amt_hi"] = np.where(void, 0, 2**64 - 1)
        rec["pid_lo"] = [p & (2**64 - 1) for p in take]
        rec["pid_hi"] = [p >> 64 for p in take]
        rec["flags"] = np.where(void, int(TF.void_pending_transfer),
                                int(TF.post_pending_transfer))
        return JMB.encode([rec.tobytes()], 128)

    def empty(self, n: int = BODY) -> bytes:
        """Every event fails, none transiently: nothing is created and no
        id is poisoned."""
        rec = self._records(n)
        rec["cr_lo"] = rec["dr_lo"]
        return JMB.encode([rec.tobytes()], 128)

    def hard(self, n: int = BODY) -> bytes:
        """A repeated id: no device tier runs it (the mirror does)."""
        rec = self._records(n)
        rec["id_lo"][-1] = rec["id_lo"][0]
        rec["id_hi"][-1] = rec["id_hi"][0]
        return JMB.encode([rec.tobytes()], 128)

    def window(self, bodies) -> tuple:
        return bodies, [self.next_ts(BODY) for _ in bodies]


def ids_body(ids) -> bytes:
    return JMB.encode([b"".join(i.to_bytes(16, "little") for i in ids)], 16)


def query_bodies(tr: Traffic) -> list:
    AFF = JT.AccountFilterFlags
    both = int(AFF.debits | AFF.credits)
    xids = [tr.next_id - 1, tr.next_id - BODY, (1 << 64) + 10**6 + 3, 12345]
    return [
        (O.lookup_accounts, ids_body([1, 4, 8, 9, N_ACCOUNTS, 999])),
        (O.lookup_transfers, ids_body(xids)),
        (O.get_account_transfers, JMB.encode([JT.AccountFilter(
            account_id=4, limit=60, flags=both).pack()], 128)),
        (O.get_account_transfers, JMB.encode([JT.AccountFilter(
            account_id=5, limit=30, user_data_64=(1 << 63) + 2,
            flags=both | int(AFF.reversed)).pack()], 128)),
        (O.get_account_balances, JMB.encode([JT.AccountFilter(
            account_id=8, limit=60, flags=both).pack()], 128)),
        (O.query_accounts, JMB.encode([JT.QueryFilter(
            code=2, limit=40).pack()], 64)),
        (O.query_transfers, JMB.encode([JT.QueryFilter(
            user_data_64=(1 << 63) + 1, code=2, limit=50).pack()], 64)),
        (O.query_transfers, JMB.encode([JT.QueryFilter(
            ledger=1, limit=40, flags=1).pack()], 64)),
        (O.get_change_events, JT.ChangeEventsFilter(limit=80).pack()),
    ]


def run_script(pair: Pair, tr: Traffic) -> None:
    """40 ops, a checkpoint every 8: single bodies, all_or_nothing
    windows (an empty prepare in one), pipelined windows two deep, posts
    and voids, a hard body (the ledger's batches then stay on the mirror
    for a while), a pulse past the timeouts, the bar boundary at op 32."""
    pair.commit(O.create_accounts, tr.accounts(), tr.next_ts(N_ACCOUNTS))
    for op in range(2, 9):                                    # ops 2-8
        body = tr.resolve() if op == 6 else tr.plain()
        pair.commit(O.create_transfers, body, tr.next_ts(BODY))
    pair.commit_window(*tr.window(                            # ops 9-12
        [tr.plain(), tr.empty(), tr.plain(), tr.plain()]))
    pair.commit_window(*tr.window([tr.plain() for _ in range(4)]))
    pair.pipelined([tr.window([tr.plain(fail=False), tr.plain(fail=False)])
                    for _ in range(3)])                       # ops 17-22
    pair.commit(O.create_transfers, tr.resolve(), tr.next_ts(BODY))
    pair.commit(O.create_transfers, tr.plain(), tr.next_ts(BODY))
    pair.commit(O.create_transfers, tr.hard(), tr.next_ts(BODY))  # 25
    ts = tr.ts + 5 * 10**9
    tr.ts = ts
    assert pair.port.sm.pulse_needed(ts) and pair.jax.sm.pulse_needed(ts)
    pair.commit(O.pulse, b"", ts)                             # op 26
    for _ in range(27, 33):                                   # ops 27-32
        pair.commit(O.create_transfers, tr.plain(), tr.next_ts(BODY))
    pair.commit_window(*tr.window([tr.plain() for _ in range(4)]))
    for _ in range(37, 41):
        pair.commit(O.create_transfers, tr.plain(), tr.next_ts(BODY))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_durable_files_and_reads_match_jax(seed):
    pair = Pair()
    tr = Traffic(seed)
    run_script(pair, tr)
    assert pair.jax.op == pair.port.op == 40
    assert pair.checked == 5
    # Both paths ran, on both packages alike.
    assert pair.port.paths == pair.jax.paths
    assert pair.port.paths["columns"] > 20 and pair.port.paths["object"] > 3
    assert pair.port.sm.led.fallbacks == pair.jax.sm.led.fallbacks >= 1
    # One more op, then reads from the forest (cold, warm, and with
    # VERIFY on), none of which drains the mirror.
    pair.commit(O.create_transfers, tr.plain(), tr.next_ts(BODY))
    assert pair.port.sm.led._mirror_chunks
    for attempt in ("cold", "warm", "verify"):
        TC.set_verify(attempt == "verify")
        JC.set_verify(attempt == "verify")
        try:
            for op, body in query_bodies(tr):
                got = pair.port.sm.commit(TT.Operation(int(op)), body,
                                          tr.ts)
                assert got == pair.jax.sm.commit(op, body, tr.ts), \
                    (attempt, op)
                assert got or op == O.get_account_balances, (attempt, op)
        finally:
            TC.set_verify(False)
            JC.set_verify(False)
    assert pair.port.sm.led._mirror_chunks
    assert len(pair.port.sm._acct_cache) > 0


def test_restart_from_the_data_file(tmp_path):
    """The port's replica restarts from its FileStorage: superblock,
    root, `DurableState.open`, the state setter rebuilding the device
    ledger. Its digest is the one before, and the next ops' replies and
    files equal the JAX package's, whose replica kept running."""
    pair = Pair(path=str(tmp_path / "replica.tigerbeetle"))
    tr = Traffic(3)
    pair.commit(O.create_accounts, tr.accounts(), tr.next_ts(N_ACCOUNTS))
    for op in range(2, 9):
        body = tr.resolve() if op == 5 else tr.plain()
        pair.commit(O.create_transfers, body, tr.next_ts(BODY))
    pair.commit_window(*tr.window([tr.plain() for _ in range(4)]))
    pair.commit(O.create_transfers, tr.hard(), tr.next_ts(BODY))
    for _ in range(14, 17):
        pair.commit(O.create_transfers, tr.plain(), tr.next_ts(BODY))
    assert pair.checked == 2
    node = pair.port
    before = device_state_digest(node.sm.led.state)
    op, persisted = node.op, node.durable.events_persisted
    node.storage.close()

    storage = TS.FileStorage(str(tmp_path / "replica.tigerbeetle"),
                             TS.TEST_LAYOUT)
    sb = TSB.SuperBlock.load(storage)
    assert sb.op_checkpoint == op == 16
    root = storage.read("snapshot",
                        sb.snapshot_slot * TS.TEST_LAYOUT.snapshot_size_max,
                        sb.snapshot_size)
    assert tchecksum(root, domain=b"ckptroot") == sb.snapshot_checksum
    durable = TD.DurableState(storage)
    state = durable.open(root, load_events=False)
    assert durable.events_persisted == persisted
    sm = StateMachine("device", a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    sm.state = state
    sm.attach_durable(durable)
    assert device_state_digest(sm.led.state) == before
    node.sm, node.storage, node.durable, node.sb = sm, storage, durable, sb
    for _ in range(17, 25):
        pair.commit(O.create_transfers, tr.plain(), tr.next_ts(BODY))
    pair.commit_window(*tr.window([tr.plain() for _ in range(4)]))
    pair.commit(O.create_transfers, tr.resolve(), tr.next_ts(BODY))
    assert pair.checked == 3
    for op_, body in query_bodies(tr):
        assert (sm.commit(TT.Operation(int(op_)), body, tr.ts)
                == pair.jax.sm.commit(op_, body, tr.ts))
    storage.close()


def _policy_flush(sm, durable, D):
    led = sm.led
    cols = led.take_flush_columns() if led is not None else None
    raw = sm.raw_state
    if cols and not D.mirror_quiescent(raw, durable.events_persisted):
        sm.state
        cols = None
    sm.cache_upsert(*durable.flush(raw, flush_columns=cols))
    return cols is not None


def _memtables(durable) -> dict:
    return {name: dict(t.memtable) for name, t in durable.forest.trees.items()}


@pytest.mark.parametrize("hard", [False, True], ids=["columns", "hard"])
def test_column_flush_matches_object_flush(hard):
    """The column path writes what the object path writes: the port's
    device engine against its oracle engine and against the JAX
    package's device engine, tree by tree (within one bar, as the JAX
    package's test_vectorized_column_flush_matches_object_flush and
    test_column_flush_hard_batch_interleave_matches_oracle hold it)."""
    tr = Traffic(5)
    bodies = [tr.accounts()] + [tr.plain() for _ in range(3)]
    bodies.append(tr.hard() if hard else tr.resolve())
    bodies += [tr.plain(n=60) for _ in range(4)]
    tss = [tr.next_ts(BODY) for _ in bodies]
    out = {}
    for name, build, D in (
            ("device", lambda: StateMachine("device", a_cap=A_CAP,
                                            t_cap=T_CAP, device="cpu"), TD),
            ("oracle", lambda: StateMachine("oracle", device="cpu"), TD),
            ("jax", lambda: JSM(engine="device", a_cap=A_CAP, t_cap=T_CAP),
             JD)):
        sm = build()
        durable = D.DurableState((TS if D is TD else JS).MemoryStorage(
            TS.TEST_LAYOUT if D is TD else JS.TEST_LAYOUT))
        sm.attach_durable(durable)
        columns = 0
        for i, (body, ts) in enumerate(zip(bodies, tss)):
            op = O.create_accounts if i == 0 else O.create_transfers
            sm.commit(op if name == "jax" else TT.Operation(int(op)), body,
                      ts)
            columns += _policy_flush(sm, durable, D)
        out[name] = (_memtables(durable), columns)
    assert out["device"][0] == out["oracle"][0]
    assert out["device"][0] == out["jax"][0]
    assert out["device"][1] == out["jax"][1] >= 6
    assert out["oracle"][1] == 0


def test_cache_invalidated_after_column_flush():
    """A cached account never serves its balance from before a column
    flush: the flushed ids leave the cache, the next read misses into the
    trees."""
    sm = StateMachine("device", a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    durable = TD.DurableState(TS.MemoryStorage(TS.TEST_LAYOUT))
    sm.attach_durable(durable)
    assert sm.led.recycle_events and sm.led.retain_flush_columns
    sm.create_accounts([TT.Account(id=1, ledger=1, code=1),
                        TT.Account(id=2, ledger=1, code=1)], 1000)
    _policy_flush(sm, durable, TD)
    assert sm.lookup_accounts([1])[0].debits_posted == 0
    payload = TT.Transfer(id=10, debit_account_id=1, credit_account_id=2,
                          amount=77, ledger=1, code=1).pack()
    sm.commit(TT.Operation.create_transfers,
              JMB.encode([payload], 128), 1020)
    assert sm.lookup_accounts([1])[0].debits_posted == 0  # not flushed yet
    assert _policy_flush(sm, durable, TD)
    assert sm.lookup_accounts([1])[0].debits_posted == 77
    assert sm.led._mirror_chunks, "the reads drained the mirror"


def test_window_flush_entries_one_a_prepare():
    """all_or_nothing windows retain one flush entry a prepare, empty
    prepares too, with the JAX package's abs_start and orphan ids;
    take_flush_columns refuses a short pop."""
    tr = Traffic(7)
    accounts = tr.accounts()
    bodies = [tr.plain(), tr.empty(), tr.plain()]
    tss = [10**12 + 10**6 * (i + 1) for i in range(3)]
    entries = {}
    for name in ("port", "jax"):
        node = Node(name == "port")
        node.sm.commit(node.op_name(O.create_accounts), accounts, 10**12)
        node.sm.led.take_flush_columns()
        replies, shape = node.sm.commit_window(
            node.op_name(O.create_transfers), bodies, tss,
            all_or_nothing=True)
        assert shape == [1, 1, 1]
        cols = node.sm.led._flush_columns
        entries[name] = [(n, a, list(o)) for _, _, _, n, a, o in cols]
        with pytest.raises(AssertionError):
            node.sm.led.take_flush_columns(4)
        assert len(node.sm.led.take_flush_columns(3)) == 3
    assert entries["port"] == entries["jax"]
    assert entries["port"][1][0] == 0
    assert entries["port"][0][2], "the first body poisons ids"
