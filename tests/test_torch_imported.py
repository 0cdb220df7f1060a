"""Port parity: the imported tiers, on the CPU.

Kernel level: each batch runs from the same pre-state through the JAX
package's `create_transfers_imported_jit`,
`create_transfers_imported_fixpoint_jit` and
`create_transfers_imported_fixpoint_deep_jit` (accounts:
`create_accounts_imported_jit`; windows:
`create_transfers_super_imported_jit`) and through the port's
counterparts. Compared exactly: statuses, timestamps, the fallback,
escalation and cause flags, created counts, and every live row of the
state and of both hash tables. The state's commit_ts is the one field
held to the oracle instead: the JAX package's imported tiers leave it
at the prepare timestamp, where the oracle (and the port) keep the last
applied imported timestamp. A batch that no tier falls back on also
runs on the oracle, whose statuses, timestamps and state digest the
port must give.

Ledger level: the port's DeviceLedger, the JAX package's and the oracle
fed the same traffic: the same results, the same ladder, route and
cause counters, the port's digest equal to the oracle's and, commit_ts
aside, to the JAX ledger's.

The cases are those of the JAX package's tests/test_imported_fast.py
(its fuzz differential at seeds 1-3) and the imported x closing case of
tests/test_closing_native.py. Inputs are made with numpy from a seed;
the kernels run at one pad bucket (128), the ledgers at 1024.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.oracle import StateMachineOracle
from tigerbeetle_tpu.ops import batch as JB
from tigerbeetle_tpu.ops import fast_kernels as JFK
from tigerbeetle_tpu.ops import ledger as JL
from tigerbeetle_tpu.ops.state_epoch import device_state_digest as jax_digest
from tigerbeetle_tpu.ops.state_epoch import oracle_state_digest
from tigerbeetle_tpu.types import Account, Transfer
from tigerbeetle_tpu.types import AccountFlags as AF
from tigerbeetle_tpu.types import TransferFlags as TF
from tigerbeetle_tpu_torch import DeviceLedger
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.convert import state_from_numpy, state_to_numpy
from tigerbeetle_tpu_torch.ops import fast_kernels as TFK
from tigerbeetle_tpu_torch.ops.ledger import events_to_device
from tigerbeetle_tpu_torch.ops.state_epoch import device_state_digest
from tigerbeetle_tpu_torch.ops.u64 import carrier

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

A_CAP = 256
T_CAP = 2048
N_PAD = 128
L_A_CAP = 1 << 10
L_T_CAP = 1 << 13
IMP = int(TF.imported)
PEND = int(TF.pending)
POST = int(TF.post_pending_transfer)
VOID = int(TF.void_pending_transfer)
LINKED = int(TF.linked)
CLOSE_DR = int(TF.closing_debit)
U128_MAX = (1 << 128) - 1

TIERS = {
    "imported": (JFK.create_transfers_imported_jit,
                 TFK.create_transfers_imported),
    "fixpoint": (JFK.create_transfers_imported_fixpoint_jit,
                 TFK.create_transfers_imported_fixpoint),
    "deep": (JFK.create_transfers_imported_fixpoint_deep_jit,
             TFK.create_transfers_imported_fixpoint_deep),
}
OUT_KEYS = ("fallback", "limit_only", "limit_hit", "fix_unconverged",
            "fix_rounds", "created_count")
_jit_accounts = jax.jit(JFK.create_accounts_fast)


@pytest.fixture(autouse=True)
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _assert_states_equal(got: dict, want: dict, commit: bool = True):
    """Port state (numpy view) vs JAX state, dump row/bucket excepted;
    commit=False leaves commit_ts out."""
    for store in ("accounts", "transfers", "events"):
        for k, w in want[store].items():
            g = got[store][k]
            if k == "count":
                assert int(g) == int(w), (store, k)
            else:
                np.testing.assert_array_equal(g[:-1], w[:-1],
                                              err_msg=f"{store}.{k}")
    for table in ("acct_ht", "xfer_ht"):
        np.testing.assert_array_equal(got[table]["packed"][:-1],
                                      want[table]["packed"][:-1],
                                      err_msg=table)
    for k in ("acct_key_max", "xfer_key_max", "pulse_next") + (
            ("commit_ts",) if commit else ()):
        assert int(got[k]) == int(want[k]), k


def _assert_outs_equal(t_out, j_out, tag):
    np.testing.assert_array_equal(t_out["r_status"].numpy(),
                                  j_out["r_status"].astype(np.int64),
                                  err_msg=tag)
    np.testing.assert_array_equal(t_out["r_ts"].numpy().view(np.uint64),
                                  j_out["r_ts"], err_msg=tag)
    for k in OUT_KEYS:
        if k in j_out:
            assert int(t_out[k]) == int(j_out[k]), (tag, k)
    assert ({k: bool(v) for k, v in t_out["fb_causes"].items()}
            == {k: bool(v) for k, v in j_out["fb_causes"].items()}), tag


def _imp(id_, dr, cr, amt, uts, flags=IMP, timeout=0, pid=0):
    return Transfer(id=id_, debit_account_id=dr, credit_account_id=cr,
                    amount=amt, ledger=1, code=1, flags=flags,
                    timeout=timeout, pending_id=pid, timestamp=uts)


class KPair:
    """A JAX ledger state and the oracle, stepped together; every batch
    also runs through the port's tiers from the same pre-state."""

    def __init__(self, accounts=None, ts=10**9):
        self.js = JL.init_state(A_CAP, T_CAP)
        self.sm = StateMachineOracle()
        self.ts = ts
        if accounts is None:
            accounts = [Account(id=i, ledger=1, code=1) for i in range(1, 9)]
        self.accounts(accounts, ts=100)

    def _advance(self, j_state):
        """Continue from the JAX state, with the oracle's commit_ts."""
        self.js = dict(j_state,
                       commit_ts=jnp.uint64(self.sm.commit_timestamp))

    def _oracle_check(self, fn, events, ts, outs, n):
        """The oracle applies the batch; each tier that did not fall back
        must give its statuses, timestamps and state digest."""
        want = getattr(self.sm, fn)(events, ts)
        digest = oracle_state_digest(self.sm, A_CAP)
        for tag, (t_state, t_out) in outs.items():
            assert ([int(s) for s in t_out["r_status"][:n].tolist()]
                    == [int(r.status) for r in want]), tag
            assert ([int(t) & ((1 << 64) - 1)
                     for t in t_out["r_ts"][:n].tolist()]
                    == [r.timestamp for r in want]), tag
            assert device_state_digest(t_state) == digest, tag
        return [r.status.name for r in want]

    def accounts(self, accounts, ts=None, imported=False):
        n = len(accounts)
        ts = self.ts if ts is None else ts
        ev = JL.pad_account_events(JB.accounts_to_arrays(accounts), N_PAD)
        pre = _np(self.js)
        jfn = JFK.create_accounts_imported_jit if imported else _jit_accounts
        j_state, j_out = jfn(jax.tree_util.tree_map(jnp.asarray, pre), ev,
                             np.uint64(ts), np.int32(n))
        t_state, t_out = TFK.create_accounts_fast(
            state_from_numpy(pre, "cpu"), events_to_device(ev, "cpu"), ts,
            n, imported_mode=imported)
        j_out = _np(j_out)
        np.testing.assert_array_equal(t_out["r_status"].numpy(),
                                      j_out["r_status"].astype(np.int64))
        np.testing.assert_array_equal(t_out["r_ts"].numpy().view(np.uint64),
                                      j_out["r_ts"])
        assert bool(t_out["fallback"]) == bool(j_out["fallback"])
        _assert_states_equal(state_to_numpy(t_state), _np(j_state),
                             commit=False)
        if bool(j_out["fallback"]):
            _assert_states_equal(state_to_numpy(t_state), pre)
            return None
        names = self._oracle_check("create_accounts", accounts, ts,
                                   {"accounts": (t_state, t_out)}, n)
        self._advance(j_state)
        return names

    def transfers(self, events, ts, tiers=tuple(TIERS)):
        """Run the batch on each tier; returns (oracle statuses or None
        when every tier fell back, {tier: port out})."""
        n = len(events)
        ev = JL.pad_transfer_events(JB.transfers_to_arrays(events), N_PAD)
        pre = _np(self.js)
        outs, done, nxt = {}, {}, None
        for tier in tiers:
            jfn, tfn = TIERS[tier]
            j_state, j_out = jfn(jax.tree_util.tree_map(jnp.asarray, pre),
                                 ev, np.uint64(ts), np.int32(n))
            t_state, t_out = tfn(state_from_numpy(pre, "cpu"),
                                 events_to_device(ev, "cpu"), ts, n)
            j_out = _np(j_out)
            _assert_outs_equal(t_out, j_out, tier)
            got = state_to_numpy(t_state)
            _assert_states_equal(got, _np(j_state), commit=False)
            outs[tier] = t_out
            if bool(j_out["fallback"]):
                _assert_states_equal(got, pre)
            else:
                done[tier] = (t_state, t_out)
                nxt = nxt or j_state
        if nxt is None:
            return None, outs
        names = self._oracle_check("create_transfers", events, ts, done, n)
        self._advance(nxt)
        return names, outs


# ------------------------------------------------------- imported_batch_ctx

def test_imported_batch_ctx_matches_the_jax_package():
    """The context against the JAX package's on the int64 sort traps:
    user timestamps equal to the first and the last live account's, one
    above every account, 0, u64::MAX and 2^63 (the padding rows read as
    u64::MAX, which sorts first as int64), over one batch and over three
    prepares (per-prepare homogeneity and commit timestamps)."""
    pair = KPair()
    imp_accts = [Account(id=50 + i, ledger=1, code=1, flags=AF.imported,
                         timestamp=5000 + 7 * i) for i in range(5)]
    assert pair.accounts(imp_accts, ts=10**8, imported=True) == [
        "created"] * 5
    acct_ts = sorted(a.timestamp for a in pair.sm.accounts.values())
    uts = [acct_ts[0], acct_ts[-1], acct_ts[-1] + 1, 0, (1 << 64) - 1,
           1 << 63, acct_ts[3], 5014, 5015, acct_ts[1]]
    xs = [_imp(100 + i, 1, 2, 1, t,
               flags=IMP if i not in (0, 4) else 0)
          for i, t in enumerate(uts)]
    ev = JL.pad_transfer_events(JB.transfers_to_arrays(xs), N_PAD)
    for seg_starts in ((0,), (0, 3, 7)):
        seg_start = np.zeros(N_PAD, dtype=bool)
        seg_start[list(seg_starts)] = True
        ts_event = (np.arange(N_PAD, dtype=np.uint64) * np.uint64(3)
                    + np.uint64(10**9))
        idxs = np.arange(N_PAD, dtype=np.int32)
        want = _np(JFK.imported_batch_ctx(
            jax.tree_util.tree_map(jnp.asarray, _np(pair.js)),
            {k: jnp.asarray(v) for k, v in ev.items()}, jnp.asarray(ts_event),
            jnp.asarray(ev["valid"]), jnp.asarray(idxs),
            jnp.asarray(seg_start)))
        t_ev = events_to_device(ev, "cpu")
        got = TFK.imported_batch_ctx(
            state_from_numpy(_np(pair.js), "cpu"), t_ev,
            carrier(ts_event, "cpu"), t_ev["valid"],
            torch.arange(N_PAD, dtype=torch.int64),
            torch.from_numpy(seg_start))
        for k in ("batch_imported", "acct_ts_collision"):
            np.testing.assert_array_equal(got[k].numpy(), want[k], k)
        np.testing.assert_array_equal(got["batch_ts"].numpy().view(np.uint64),
                                      want["batch_ts"])
        assert int(got["key_max"]) == int(want["key_max"])
        coll = got["acct_ts_collision"].numpy()[:len(xs)]
        assert coll.tolist() == [False, True, False, False, False, False,
                                 True, True, False, True]


# ------------------------------------------------- per batch, kernel level

def test_monotone_batch_all_created_with_user_timestamps():
    pair = KPair()
    xs = [_imp(1000 + i, 1 + i % 4, 5 + i % 4, 10, 5000 + i * 10)
          for i in range(64)]
    names, outs = pair.transfers(xs, 10**9)
    assert names == ["created"] * 64
    assert not bool(outs["imported"]["fallback"])
    assert int(pair.sm.commit_timestamp) == 5630


def test_in_batch_regress_maxima_chain():
    pair = KPair()
    uts = [5000, 4900, 5100, 5050, 5200, 5200, 5300]
    names, _ = pair.transfers(
        [_imp(2000 + i, 1, 2, 1, t) for i, t in enumerate(uts)], 10**9)
    assert names == [
        "created", "imported_event_timestamp_must_not_regress",
        "created", "imported_event_timestamp_must_not_regress",
        "created", "imported_event_timestamp_must_not_regress",
        "created"]


def test_regress_vs_state_key_max():
    pair = KPair()
    pair.transfers([_imp(3000, 1, 2, 1, 7000)], 10**9)
    names, _ = pair.transfers([_imp(3001, 1, 2, 1, 6999),
                               _imp(3002, 1, 2, 1, 7000),
                               _imp(3003, 1, 2, 1, 7001)], 2 * 10**9)
    assert names == ["imported_event_timestamp_must_not_regress",
                     "imported_event_timestamp_must_not_regress",
                     "created"]


def test_postdate_accounts_and_collision():
    pair = KPair()
    acct_ts = pair.sm.accounts[1].timestamp
    names, _ = pair.transfers(
        [_imp(4000, 1, 2, 1, acct_ts), _imp(4001, 1, 2, 1, acct_ts - 1),
         _imp(4002, 1, 2, 1, pair.sm.accounts[8].timestamp + 1)], 10**9)
    assert names[0] == "imported_event_timestamp_must_not_regress"
    assert names[1].startswith("imported_event_timestamp_must")
    assert names[2] == "created"


def test_wrapper_rules():
    pair = KPair()
    batch_ts = 10**9
    xs = [_imp(5000, 1, 2, 1, batch_ts), _imp(5001, 1, 2, 1, 0),
          _imp(5002, 1, 2, 1, 1 << 63),
          Transfer(id=5003, debit_account_id=1, credit_account_id=2,
                   amount=1, ledger=1, code=1),
          _imp(5004, 1, 2, 1, 8000)]
    names, _ = pair.transfers(xs, batch_ts)
    assert names == ["imported_event_timestamp_must_not_advance",
                     "imported_event_timestamp_out_of_range",
                     "imported_event_timestamp_out_of_range",
                     "imported_event_expected", "created"]


def test_not_expected_in_plain_batch():
    pair = KPair()
    names, _ = pair.transfers(
        [Transfer(id=6000, debit_account_id=1, credit_account_id=2,
                  amount=1, ledger=1, code=1), _imp(6001, 1, 2, 1, 9000)],
        10**9)
    assert names == ["created", "imported_event_not_expected"]


def test_imported_pending_and_post():
    pair = KPair()
    names, _ = pair.transfers([_imp(7000, 1, 2, 50, 9100, flags=IMP | PEND),
                               _imp(7001, 1, 2, 1, 9200, flags=IMP | PEND,
                                    timeout=5)], 10**9)
    assert names == ["created", "imported_event_timeout_must_be_zero"]
    names, _ = pair.transfers([_imp(7002, 0, 0, U128_MAX, 9300,
                                    flags=IMP | POST, pid=7000)], 2 * 10**9)
    assert names == ["created"]


def test_after_regress_precedence_override():
    """A postdate failure that also regresses in-batch reports regress
    (the sequential key_max already advanced)."""
    pair = KPair()
    names, _ = pair.transfers([_imp(8000, 1, 2, 1, 6000),
                               _imp(8001, 3, 4, 1, 5999)], 10**9)
    assert names == ["created", "imported_event_timestamp_must_not_regress"]
    # And against an account's timestamp: above key_max, below the
    # account's creation, and below the in-batch max.
    pair2 = KPair()
    late = Account(id=20, ledger=1, code=1, flags=AF.imported,
                   timestamp=7000)
    pair2.accounts([late], ts=10**8, imported=True)
    names, _ = pair2.transfers([_imp(8100, 1, 2, 1, 6500),
                                _imp(8101, 20, 2, 1, 6400),
                                _imp(8102, 20, 2, 1, 7100)], 10**9)
    assert names == ["created", "imported_event_timestamp_must_not_regress",
                     "created"]


def test_chains_fall_back():
    """An imported event and a linked chain in one batch: every imported
    tier falls back (e1) with the state untouched."""
    pair = KPair()
    names, outs = pair.transfers(
        [_imp(9000, 1, 2, 1, 12000, flags=IMP | LINKED),
         _imp(9001, 1, 99, 1, 12100)], 10**9)
    assert names is None
    assert all(bool(o["fb_causes"]["e1_hard_flags"]) for o in outs.values())
    assert not bool(outs["imported"]["limit_only"])


def test_duplicate_imported_id_and_orphan():
    pair = KPair()
    pair.transfers([_imp(9100, 1, 2, 7, 13000)], 10**9)
    names, _ = pair.transfers([_imp(9100, 1, 2, 7, 13500),
                               _imp(9101, 1, 2, 7, 13000)], 2 * 10**9)
    assert names == ["exists", "imported_event_timestamp_must_not_regress"]
    names, _ = pair.transfers([_imp(9101, 1, 2, 7, 14000)], 3 * 10**9)
    assert names == ["created"]
    # A repeated id inside one batch: a collision, hard on every tier.
    names, outs = pair.transfers([_imp(9200, 1, 2, 7, 15000),
                                  _imp(9200, 1, 2, 7, 15001)], 4 * 10**9)
    assert names is None
    assert all(bool(o["fb_causes"]["e2_collision"]) for o in outs.values())


def test_closing_escalates_to_the_imported_fixpoint_tier():
    """tests/test_closing_native.py's imported x closing case: an imported
    closing pending closes account 1, a later imported transfer dies on
    it (and never advances the running max), and one below it creates.
    The plain imported tier escalates (limit_only, 'closing'); the
    fixpoint tiers run it. A later void reopens the account."""
    pair = KPair()
    names, outs = pair.transfers([
        _imp(30, 1, 2, 5, 500, flags=IMP | PEND | CLOSE_DR),
        _imp(31, 1, 3, 1, 600),
        _imp(32, 3, 4, 1, 550)], 10**12)
    assert names == ["created", "debit_account_already_closed", "created"]
    assert bool(outs["imported"]["limit_only"])
    assert bool(outs["imported"]["fb_causes"]["closing"])
    assert not bool(outs["fixpoint"]["fallback"])
    names, _ = pair.transfers([Transfer(id=33, pending_id=30, flags=VOID)],
                              10**12 + 10**6, tiers=("fixpoint",))
    assert names == ["created"]


def test_limit_breach_escalates_and_resolves():
    """Imported transfers against a debit-limited account: the headroom
    proof fails on the plain imported tier (limit_only); the fixpoint
    tiers resolve the breaches, and a regress lane among them keeps its
    precedence over exceeds_credits."""
    accts = [Account(id=i, ledger=1, code=1) for i in range(1, 9)]
    accts[0] = Account(id=1, ledger=1, code=1,
                       flags=AF.debits_must_not_exceed_credits)
    pair = KPair(accts)
    pair.transfers([_imp(40, 2, 1, 30, 1000)], 10**9)
    xs = [_imp(41, 1, 3, 20, 2000), _imp(42, 1, 3, 20, 2100),
          _imp(43, 1, 3, 50, 1990), _imp(44, 1, 3, 5, 2200)]
    names, outs = pair.transfers(xs, 2 * 10**9)
    assert names == ["created", "exceeds_credits",
                     "imported_event_timestamp_must_not_regress", "created"]
    assert bool(outs["imported"]["limit_only"])
    assert int(outs["fixpoint"]["fix_rounds"]) >= 2


# --------------------------------------------------- accounts, kernel level

def test_imported_accounts_kernel():
    """create_accounts_imported: monotone creation with user timestamps,
    the maxima chain and the wrapper rules, a collision with a transfer
    timestamp (the last live transfer row's, one above every row, and 0),
    a linked chain beside an imported account (falls back)."""
    pair = KPair()
    imp = int(AF.imported)
    assert pair.accounts(
        [Account(id=100 + i, ledger=1, code=1, flags=imp,
                 timestamp=5000 + i * 10) for i in range(16)],
        ts=10**8, imported=True) == ["created"] * 16
    names = pair.accounts([
        Account(id=200, ledger=1, code=1, flags=imp, timestamp=7000),
        Account(id=201, ledger=1, code=1, flags=imp, timestamp=6500),
        Account(id=202, ledger=1, code=1, flags=imp, timestamp=7200),
        Account(id=203, ledger=1, code=1),
        Account(id=204, ledger=1, code=1, flags=imp, timestamp=0),
        Account(id=205, ledger=1, code=1, flags=imp, timestamp=10**9 + 5)],
        ts=10**9, imported=True)
    assert names == ["created", "imported_event_timestamp_must_not_regress",
                     "created", "imported_event_expected",
                     "imported_event_timestamp_out_of_range",
                     "imported_event_timestamp_must_not_advance"]
    pair.transfers([_imp(30000, 1, 2, 1, 40000), _imp(30001, 1, 2, 1, 40010)],
                   2 * 10**9)
    names = pair.accounts([
        Account(id=300, ledger=1, code=1, flags=imp, timestamp=40010),
        Account(id=301, ledger=1, code=1, flags=imp, timestamp=40011),
        Account(id=302, ledger=1, code=1, flags=imp, timestamp=40000)],
        ts=3 * 10**9, imported=True)
    assert names == ["imported_event_timestamp_must_not_regress", "created",
                     "imported_event_timestamp_must_not_regress"]
    assert pair.accounts([
        Account(id=400, ledger=1, code=1, flags=imp | AF.linked,
                timestamp=50000),
        Account(id=401, ledger=1, code=1, flags=imp, timestamp=50001)],
        ts=4 * 10**9, imported=True) is None
    assert int(pair.sm.commit_timestamp) == 40011


# ------------------------------------------------------ windows, kernel level

def test_super_imported_window_kernel():
    """tests/test_imported_fast.py's mixed sub-batch window on
    create_transfers_super_imported: homogeneity per prepare, the maxima
    chain across the window; statuses, timestamps and the state equal
    the JAX package's (commit_ts the oracle's), and a window with a
    linked chain falls back whole."""
    pair = KPair()
    b1 = [_imp(11000 + i, 1, 2, 1, 20000 + i * 5) for i in range(8)]
    b2 = [Transfer(id=11100 + i, debit_account_id=2, credit_account_id=3,
                   amount=1, ledger=1, code=1) for i in range(8)]
    b3 = [_imp(11200, 1, 2, 1, 10**9 + 900), _imp(11201, 1, 2, 1,
                                                  10**9 + 1500)]
    tss = [10**9, 10**9 + 1000, 10**9 + 2000]
    for batches, falls in (((b1, b2, b3), False),
                           (([_imp(11300, 1, 2, 1, 10**9 + 2100,
                                   flags=IMP | LINKED)], b2[:1]), True)):
        tss_w = tss[:len(batches)] if not falls else [10**9 + 3000,
                                                      10**9 + 4000]
        ev, seg = JL.stack_superbatch(
            [JB.transfers_to_arrays(b) for b in batches], tss_w, N_PAD)
        pre = _np(pair.js)
        j_state, j_out = JFK.create_transfers_super_imported_jit(
            jax.tree_util.tree_map(jnp.asarray, pre), ev, seg)
        t_state, t_out = TFK.create_transfers_super_imported(
            state_from_numpy(pre, "cpu"),
            {k: carrier(v, "cpu") for k, v in ev.items()},
            {k: carrier(v, "cpu") for k, v in seg.items()})
        j_out = _np(j_out)
        _assert_outs_equal(t_out, j_out, "super_imported")
        _assert_states_equal(state_to_numpy(t_state), _np(j_state),
                             commit=False)
        assert bool(j_out["fallback"]) == falls
        if falls:
            _assert_states_equal(state_to_numpy(t_state), pre)
            continue
        st = t_out["r_status"].numpy().reshape(len(batches), N_PAD)
        ts = t_out["r_ts"].numpy().view(np.uint64).reshape(len(batches),
                                                           N_PAD)
        for b, (batch, t) in enumerate(zip(batches, tss_w)):
            want = pair.sm.create_transfers(batch, t)
            assert st[b, :len(batch)].tolist() == [int(r.status)
                                                   for r in want]
            assert ts[b, :len(batch)].tolist() == [r.timestamp for r in want]
        assert device_state_digest(t_state) == oracle_state_digest(pair.sm,
                                                                   A_CAP)
        pair._advance(j_state)
        assert [r.status.name for r in want] == [
            "imported_event_timestamp_must_not_regress", "created"]


# ------------------------------------------------------------ the ledgers

class Trio:
    """The port's ledger (CPU), the JAX package's and the oracle."""

    def __init__(self, accounts=None):
        self.port = DeviceLedger(a_cap=L_A_CAP, t_cap=L_T_CAP, device="cpu")
        self.jax = JL.DeviceLedger(a_cap=L_A_CAP, t_cap=L_T_CAP)
        self.sm = StateMachineOracle()
        if accounts is None:
            accounts = [Account(id=i, ledger=1, code=1) for i in range(1, 9)]
        self.accounts(accounts, 100)

    def accounts(self, accounts, ts):
        want = [(r.timestamp, r.status.name)
                for r in self.sm.create_accounts(accounts, ts)]
        got = self.port.create_accounts(
            [TT.Account(**dataclasses.asdict(a)) for a in accounts], ts)
        ref = self.jax.create_accounts(accounts, ts)
        assert [(r.timestamp, r.status.name) for r in got] == want
        assert [(r.timestamp, r.status.name) for r in ref] == want
        self.check()
        return [s for _, s in want]

    def transfers(self, transfers, ts):
        want = [(r.timestamp, r.status.name)
                for r in self.sm.create_transfers(transfers, ts)]
        got = self.port.create_transfers(
            [TT.Transfer(**dataclasses.asdict(t)) for t in transfers], ts)
        ref = self.jax.create_transfers(transfers, ts)
        assert [(r.timestamp, r.status.name) for r in got] == want
        assert [(r.timestamp, r.status.name) for r in ref] == want
        self.check()
        return [s for _, s in want]

    def check(self):
        digest = device_state_digest(self.port.state)
        assert digest == oracle_state_digest(self.sm, L_A_CAP)
        # The JAX ledger's state, but for commit_ts (the prepare
        # timestamp after an imported batch there).
        jst = dict(self.jax.state,
                   commit_ts=jnp.uint64(int(self.port.state["commit_ts"])
                                        & ((1 << 64) - 1)))
        assert digest == jax_digest(jst)
        assert _counters(self.port) == _counters(self.jax)


def _counters(led):
    return dict(
        ladder=(led.fast_batches, led.fixpoint_batches,
                led.deep_fixpoint_batches, led.escalations, led.fallbacks),
        causes=led.fallback_causes, routes=led.window_routes,
        window_fallbacks=led.window_fallbacks,
        last=(led.last_window_route, led.last_window_tier),
        chain_fb=led.chain_batch_fallbacks)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_imported_fuzz_differential(seed):
    """tests/test_imported_fast.py's fuzz: random imported batches (edge
    timestamps around the running max, mixed flags, pendings) through
    the three ledgers, equal after every batch."""
    rng = np.random.default_rng(seed)
    trio = Trio()
    ts, base_uts, nid = 10**9, 50_000, 20_000
    for _ in range(6):
        n = int(rng.integers(4, 48))
        batch_imported = bool(rng.integers(0, 2))
        xs = []
        for i in range(n):
            imp = batch_imported if rng.random() > 0.1 else not batch_imported
            dr = int(rng.integers(1, 9))
            cr = int(rng.integers(1, 9))
            if dr == cr:
                cr = dr % 8 + 1
            flags = IMP if imp else 0
            if rng.random() < 0.15:
                flags |= PEND
            uts = base_uts + int(rng.integers(-30, 30))
            base_uts += int(rng.integers(0, 12))
            xs.append(_imp(nid, dr, cr, int(rng.integers(1, 100)), uts,
                           flags=flags,
                           timeout=int(rng.integers(0, 2))
                           if (flags & PEND and not imp) else 0))
            nid += 1
        trio.transfers(xs, ts)
        ts += 10**6
    assert trio.port.fallbacks == 0


def test_ledger_imported_ladder_matches_the_jax_ledger():
    """The per-batch imported ladder: the plain imported tier, its
    escalation to the imported fixpoint tier (closing), a chain that
    falls back to the mirror, imported accounts on their own tier, and
    the counters equal to the JAX ledger's after each batch."""
    trio = Trio()
    assert trio.transfers([_imp(1000 + i, 1 + i % 4, 5 + i % 4, 10,
                                5000 + i) for i in range(16)],
                          10**9) == ["created"] * 16
    assert trio.port.fast_batches == 2 and trio.port.fallbacks == 0
    trio.transfers([_imp(30, 1, 2, 5, 6000, flags=IMP | PEND | CLOSE_DR),
                    _imp(31, 1, 3, 1, 6100), _imp(32, 3, 4, 1, 6050)],
                   2 * 10**9)
    assert (trio.port.escalations, trio.port.fixpoint_batches) == (1, 1)
    trio.transfers([_imp(9000, 2, 3, 1, 7000, flags=IMP | LINKED),
                    _imp(9001, 2, 99, 1, 7100)], 3 * 10**9)
    assert trio.port.fallbacks == 1
    assert trio.port.fallback_causes == {"e1_hard_flags": 1}
    imp = int(AF.imported)
    assert trio.accounts([Account(id=50 + i, ledger=1, code=1, flags=imp,
                                  timestamp=7200 + i) for i in range(4)],
                         4 * 10**9) == ["created"] * 4


def test_ledger_imported_accounts_on_the_device():
    """Imported accounts run on the imported accounts tier (no mirror),
    then imported transfers postdate their user timestamps."""
    trio = Trio([])
    imp = int(AF.imported)
    assert trio.accounts([Account(id=1, ledger=1, code=1, flags=imp,
                                  timestamp=5000),
                          Account(id=2, ledger=1, code=1, flags=imp,
                                  timestamp=5001)], 10**9) == ["created"] * 2
    assert trio.transfers([_imp(31000, 1, 2, 1, 4999),
                           _imp(31001, 1, 2, 1, 6000)], 2 * 10**9) == [
        "imported_event_timestamp_must_postdate_debit_account", "created"]
    assert trio.port.fallbacks == 0 and trio.port.fast_batches == 3


def test_ledger_imported_windows():
    """An imported window takes super_imported on the synchronous path
    (all_or_nothing too) and is refused by submit_window, as in the JAX
    ledger; a window with an imported chain falls back whole and runs
    per batch."""
    trio = Trio()
    b1 = [_imp(11000 + i, 1, 2, 1, 20000 + i * 5) for i in range(8)]
    b2 = [Transfer(id=11100 + i, debit_account_id=2, credit_account_id=3,
                   amount=1, ledger=1, code=1) for i in range(8)]
    b3 = [_imp(11200, 1, 2, 1, 10**9 + 900),
          _imp(11201, 1, 2, 1, 10**9 + 1500)]
    tss = [10**9, 10**9 + 1000, 10**9 + 2000]

    def window(batches, tss, aon):
        evs = [JB.transfers_to_arrays(b) for b in batches]
        assert trio.port.submit_window(evs, tss) is None
        assert trio.jax.submit_window(evs, tss) is None
        got = trio.port.create_transfers_window(evs, tss, aon)
        ref = trio.jax.create_transfers_window(evs, tss, aon)
        want = [[(int(r.status), r.timestamp)
                 for r in trio.sm.create_transfers(b, t)]
                for b, t in zip(batches, tss)]
        for g, r, w in zip(got, ref, want):
            assert list(zip(g[0].tolist(), g[1].tolist())) == w
            assert list(zip(r[0].tolist(), r[1].tolist())) == w
        trio.check()

    window((b1, b2, b3), tss, False)
    assert trio.port.window_routes == {"super_imported": 1}
    b4 = [_imp(11300 + i, 2, 3, 1, 10**9 + 2100 + i) for i in range(4)]
    b5 = [_imp(11400 + i, 3, 4, 1, 10**9 + 3100 + i) for i in range(4)]
    window((b4, b5), [10**9 + 3000, 10**9 + 4000], True)
    assert trio.port.window_routes == {"super_imported": 2}
    b6 = [_imp(11500, 2, 3, 1, 10**9 + 4100, flags=IMP | LINKED),
          _imp(11501, 2, 3, 1, 10**9 + 4200)]
    b7 = [_imp(11600, 3, 4, 1, 10**9 + 5100)]
    window((b6, b7), [10**9 + 5000, 10**9 + 6000], False)
    assert trio.port.window_routes == {"super_imported": 3, "per_batch": 1}
    assert trio.port.window_fallbacks == 1
