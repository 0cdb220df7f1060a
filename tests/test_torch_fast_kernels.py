"""Port parity: the plain-tier create_transfers / create_accounts kernels.

Each workload batch runs through the JAX package's `create_*_fast` and
the port's, from the same ledger state (the JAX state carried over with
`state_from_numpy`). Compared exactly: r_status, r_ts, fallback,
limit_only, created_count, fb_causes, limit_hit, the state digest, and
every row of the accounts, balances, transfers and event-ring matrices
and of both hash tables (the dump row or bucket excepted: it absorbs
masked scatter lanes). A batch that falls back must leave the port's
state exactly as it was.
"""

import jax
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.ops import batch as JB
from tigerbeetle_tpu.ops import fast_kernels as JFK
from tigerbeetle_tpu.ops import ledger as JL
from tigerbeetle_tpu.ops.state_epoch import device_state_digest as jax_digest
from tigerbeetle_tpu.types import Account, Transfer
from tigerbeetle_tpu.types import AccountFlags as AF
from tigerbeetle_tpu.types import TransferFlags as TF
from tigerbeetle_tpu_torch.convert import state_from_numpy, state_to_numpy
from tigerbeetle_tpu_torch.ops import fast_kernels as TFK
from tigerbeetle_tpu_torch.ops.ledger import events_to_device
from tigerbeetle_tpu_torch.ops.state_epoch import device_state_digest

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

A_CAP = 512
T_CAP = 2048
N_PAD = 128
TS0 = 10_000_000_000_000
U128_MAX = (1 << 128) - 1

_jit_accounts = jax.jit(JFK.create_accounts_fast)
_jit_transfers = jax.jit(JFK.create_transfers_fast)


@pytest.fixture(autouse=True)
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _assert_states_equal(got: dict, want: dict):
    """Port state (numpy view) vs JAX state, dump row/bucket excepted."""
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
    for k in ("acct_key_max", "xfer_key_max", "pulse_next", "commit_ts"):
        assert int(got[k]) == int(want[k]), k


class Pair:
    """A JAX ledger state stepped by the JAX kernels, with every batch
    also run by the port's kernels from the same pre-state."""

    def __init__(self, ts=TS0):
        self.js = JL.init_state(A_CAP, T_CAP)
        self.ts = ts

    def _run(self, kind, events, ts_gap, force_fallback=None):
        n = len(events)
        self.ts += n + ts_gap
        if kind == "accounts":
            ev = JL.pad_account_events(JB.accounts_to_arrays(events), N_PAD)
            jfn, tfn = _jit_accounts, TFK.create_accounts_fast
        else:
            ev = JL.pad_transfer_events(JB.transfers_to_arrays(events),
                                        N_PAD)
            jfn, tfn = _jit_transfers, TFK.create_transfers_fast
        pre = _np(self.js)
        t_state = state_from_numpy(pre, "cpu")
        extra = {}
        if force_fallback is not None:
            extra["force_fallback"] = np.bool_(force_fallback)
        j_state, j_out = jfn(self.js, ev, np.uint64(self.ts), np.int32(n),
                             **extra)
        if force_fallback is not None:
            extra["force_fallback"] = torch.tensor(force_fallback)
        t_state, t_out = tfn(t_state, events_to_device(ev, "cpu"), self.ts,
                             n, **extra)
        j_out = _np(j_out)
        self._check_out(t_out, j_out)
        got = state_to_numpy(t_state)
        _assert_states_equal(got, _np(j_state))
        assert device_state_digest(t_state) == jax_digest(j_state)
        if bool(j_out["fallback"]):
            _assert_states_equal(got, pre)
        self.js = j_state
        return t_out

    @staticmethod
    def _check_out(t_out, j_out):
        np.testing.assert_array_equal(t_out["r_status"].numpy(),
                                      j_out["r_status"].astype(np.int64))
        np.testing.assert_array_equal(
            t_out["r_ts"].numpy().view(np.uint64), j_out["r_ts"])
        for k in ("fallback", "limit_only", "limit_hit", "fix_unconverged",
                  "fix_rounds", "created_count"):
            if k in j_out:
                assert int(t_out[k]) == int(j_out[k]), k
        if "fb_causes" in j_out:
            assert ({k: bool(v) for k, v in t_out["fb_causes"].items()}
                    == {k: bool(v) for k, v in j_out["fb_causes"].items()})

    def accounts(self, events, ts_gap=3):
        return self._run("accounts", events, ts_gap)

    def transfers(self, events, ts_gap=7, force_fallback=None):
        return self._run("transfers", events, ts_gap, force_fallback)


def _acct(i, **kw):
    kw.setdefault("ledger", 1)
    kw.setdefault("code", 10)
    return Account(id=i, **kw)


def _xfer(i, dr, cr, amount, **kw):
    kw.setdefault("ledger", 1)
    kw.setdefault("code", 1)
    return Transfer(id=i, debit_account_id=dr, credit_account_id=cr,
                    amount=amount, **kw)


def _ledger_pair():
    """Accounts 1..40 on ledger 1, 41..44 on ledger 2, 45 closed, 46-47
    balance-limited (46 debits <= credits, 47 credits <= debits)."""
    pr = Pair()
    accts = [_acct(i) for i in range(1, 41)]
    accts += [_acct(i, ledger=2) for i in range(41, 45)]
    accts += [_acct(45, flags=AF.closed),
              _acct(46, flags=AF.debits_must_not_exceed_credits),
              _acct(47, flags=AF.credits_must_not_exceed_debits)]
    out = pr.accounts(accts)
    assert not bool(out["fallback"])
    return pr


# ------------------------------------------------------- create_accounts

def test_create_accounts_new_exists_and_failures():
    pr = Pair()
    rng = np.random.default_rng(1)
    base = [_acct(int(i), user_data_128=int(rng.integers(1 << 60)) << 64,
                  user_data_64=int(rng.integers(1 << 62)),
                  user_data_32=int(rng.integers(1 << 31)))
            for i in range(1, 60)]
    base[3].flags = AF.debits_must_not_exceed_credits | AF.history
    out = pr.accounts(base)
    assert int(out["created_count"]) == 59
    b = base
    batch = [
        _acct(b[0].id, user_data_128=b[0].user_data_128,
              user_data_64=b[0].user_data_64,
              user_data_32=b[0].user_data_32),                    # exists
        _acct(b[1].id, flags=AF.credits_must_not_exceed_debits),
        _acct(b[2].id, user_data_128=1),
        _acct(b[4].id, user_data_128=b[4].user_data_128, user_data_64=5),
        _acct(b[5].id, user_data_128=b[5].user_data_128,
              user_data_64=b[5].user_data_64, user_data_32=9),
        _acct(b[6].id, user_data_128=b[6].user_data_128,
              user_data_64=b[6].user_data_64,
              user_data_32=b[6].user_data_32, ledger=3),
        _acct(b[7].id, user_data_128=b[7].user_data_128,
              user_data_64=b[7].user_data_64,
              user_data_32=b[7].user_data_32, code=99),
        _acct(100, reserved=1),
        _acct(101, flags=1 << 9),
        _acct(0),
        _acct(U128_MAX),
        _acct(102, flags=AF.debits_must_not_exceed_credits
              | AF.credits_must_not_exceed_debits),
        _acct(103, debits_pending=1),
        _acct(104, debits_posted=1 << 100),
        _acct(105, credits_pending=7),
        _acct(106, credits_posted=1 << 64),
        _acct(107, ledger=0),
        _acct(108, code=0),
        _acct(109, timestamp=5),
        _acct((1 << 127) + 110, user_data_128=U128_MAX),
        _acct(2**64 - 1),
    ]
    out = pr.accounts(batch)
    assert not bool(out["fallback"])


def test_create_accounts_linked_chains():
    pr = Pair()
    L = AF.linked
    batch = [
        _acct(1, flags=L), _acct(2, flags=L), _acct(3),           # ok chain
        _acct(4, flags=L), _acct(5, flags=L, ledger=0), _acct(6),  # broken
        _acct(7),
        _acct(8, flags=L), _acct(9, flags=L), _acct(10, flags=L),  # open
    ]
    out = pr.accounts(batch)
    assert not bool(out["fallback"])


@pytest.mark.parametrize("case", ["duplicate_id", "imported"])
def test_create_accounts_fallbacks_leave_state_unchanged(case):
    pr = Pair()
    pr.accounts([_acct(i) for i in range(1, 10)])
    if case == "duplicate_id":
        batch = [_acct(20), _acct(21), _acct(20, code=3)]
    else:
        batch = [_acct(20), _acct(21, flags=AF.imported, timestamp=5)]
    out = pr.accounts(batch)
    assert bool(out["fallback"])


# ------------------------------------------------------ create_transfers

def test_uniform_transfers():
    pr = _ledger_pair()
    rng = np.random.default_rng(2)
    for b in range(3):
        n = 100
        dr = rng.integers(1, 41, n)
        cr = rng.integers(1, 41, n)
        cr = np.where(cr == dr, cr % 40 + 1, cr)
        batch = [_xfer(1000 + 100 * b + i, int(dr[i]), int(cr[i]),
                       int(rng.integers(1, 10**6)),
                       user_data_64=int(rng.integers(1 << 40)))
                 for i in range(n)]
        out = pr.transfers(batch)
        assert not bool(out["fallback"])
        assert int(out["created_count"]) == n


def test_two_phase_post_and_void_of_committed_pendings():
    pr = _ledger_pair()
    P, POST, VOID = TF.pending, TF.post_pending_transfer, \
        TF.void_pending_transfer
    pend = [_xfer(200 + i, 1 + i, 20 + i, 1000 + i, flags=P,
                  timeout=(1 if i % 3 == 0 else 0),
                  user_data_32=i + 1)
            for i in range(12)]
    pend.append(_xfer(250, 1, 2, 500))                   # not pending
    out = pr.transfers(pend)
    assert not bool(out["fallback"])
    batch = [
        _xfer(300, 0, 0, U128_MAX, pending_id=201, flags=POST, ledger=0,
              code=0),                                   # post, full amount
        _xfer(301, 2 + 1, 0, 400, pending_id=202, flags=POST),  # partial
        _xfer(302, 0, 0, 0, pending_id=204, flags=VOID),        # void
        _xfer(303, 0, 0, 5, pending_id=205, flags=VOID),        # different
        _xfer(304, 0, 0, 5000, pending_id=207, flags=POST),     # exceeds
        _xfer(305, 0, 0, 0, pending_id=250, flags=POST),        # not pending
        _xfer(306, 0, 0, 0, pending_id=999, flags=POST),        # not found
        _xfer(307, 30, 0, 0, pending_id=208, flags=POST),       # dr differs
        _xfer(308, 0, 9, 0, pending_id=209, flags=POST),        # cr differs
        _xfer(309, 0, 0, 0, pending_id=210, flags=POST, ledger=2),
        _xfer(310, 0, 0, 0, pending_id=211, flags=POST, code=7),
        _xfer(311, 0, 0, 0, pending_id=0, flags=POST),
        _xfer(312, 0, 0, 0, pending_id=U128_MAX, flags=POST),
        _xfer(314, 0, 0, 0, pending_id=206, flags=POST | VOID),
        _xfer(315, 0, 0, 0, pending_id=203, flags=POST | P),
        _xfer(316, 0, 0, 0, pending_id=200, flags=POST, timeout=3),
    ]
    out = pr.transfers(batch)
    assert not bool(out["fallback"])
    # A post whose pending id is its own id collides in the batch's id
    # pool: the plain tier escalates it.
    out = pr.transfers([_xfer(313, 0, 0, 0, pending_id=313, flags=POST)])
    assert bool(out["fallback"]) and bool(out["limit_only"])
    # Second round: already posted / voided, and expiry of the timed
    # pendings (timeout 1 s) once the clock passes it.
    again = [
        _xfer(400, 0, 0, 0, pending_id=201, flags=POST),
        _xfer(401, 0, 0, 0, pending_id=204, flags=VOID),
        _xfer(402, 0, 0, 0, pending_id=203, flags=POST),   # expired
        _xfer(403, 0, 0, 0, pending_id=206, flags=VOID),   # expired
        _xfer(404, 0, 0, 0, pending_id=208, flags=POST),   # untimed: ok
    ]
    out = pr.transfers(again, ts_gap=3 * 10**9)
    assert not bool(out["fallback"])


def test_pulse_resets_on_post_of_the_earliest_timed_pending():
    pr = _ledger_pair()
    P, POST = TF.pending, TF.post_pending_transfer
    pr.transfers([_xfer(500, 1, 2, 10, flags=P, timeout=5),
                  _xfer(501, 3, 4, 10, flags=P, timeout=9)])
    out = pr.transfers([_xfer(502, 0, 0, 0, pending_id=500, flags=POST),
                        _xfer(503, 5, 6, 7, flags=P, timeout=2)])
    assert not bool(out["fallback"])


def test_chains_with_rollback_and_an_open_chain():
    pr = _ledger_pair()
    L = TF.linked
    batch = [
        _xfer(600, 1, 2, 10, flags=L), _xfer(601, 2, 3, 10, flags=L),
        _xfer(602, 3, 4, 10),                                # ok chain
        _xfer(603, 5, 6, 10, flags=L), _xfer(604, 6, 999, 10, flags=L),
        _xfer(605, 7, 8, 10),                                # broken
        _xfer(606, 9, 10, 10),
        _xfer(607, 11, 12, 10, flags=L | TF.pending, timeout=4),
        _xfer(608, 12, 41, 10),                              # ledger differs
        _xfer(609, 13, 14, 10, flags=L), _xfer(610, 14, 15, 10, flags=L),
    ]                                                        # open chain
    out = pr.transfers(batch)
    assert not bool(out["fallback"])
    # The broken chain's ids are free again except the transient failure
    # (id_already_failed on 604); the rolled-back ids can be created.
    out = pr.transfers([_xfer(604, 1, 2, 1), _xfer(603, 5, 6, 10),
                        _xfer(600, 1, 2, 10, flags=L)])
    assert not bool(out["fallback"])


def test_failure_statuses_of_the_plain_tier():
    pr = _ledger_pair()
    ud = dict(user_data_128=5, user_data_64=6, user_data_32=7)
    first = [_xfer(750 + i, 1, 2, 77, **ud) for i in range(12)]
    first.append(_xfer(701, 1, 999, 5))            # transient: orphan
    pr.transfers(first)
    batch = [
        _xfer(750, 1, 2, 77, **ud),                # exists
        _xfer(751, 1, 2, 77, flags=TF.pending, **ud),
        _xfer(752, 1, 2, 77, pending_id=3, **ud),
        _xfer(753, 1, 2, 77, timeout=1, **ud),
        _xfer(754, 3, 2, 77, **ud),
        _xfer(755, 1, 3, 77, **ud),
        _xfer(756, 1, 2, 78, **ud),
        _xfer(757, 1, 2, 77, user_data_128=4, user_data_64=6,
              user_data_32=7),
        _xfer(758, 1, 2, 77, user_data_128=5, user_data_64=1,
              user_data_32=7),
        _xfer(759, 1, 2, 77, user_data_128=5, user_data_64=6,
              user_data_32=1),
        _xfer(760, 1, 2, 77, ledger=2, **ud),
        _xfer(761, 1, 2, 77, code=2, **ud),
        _xfer(701, 1, 2, 5),                        # id_already_failed
        _xfer(702, 1, 2, 5, flags=1 << 12),         # reserved_flag
        _xfer(0, 1, 2, 5),
        _xfer(U128_MAX, 1, 2, 5),
        _xfer(703, 0, 2, 5),
        _xfer(704, U128_MAX, 2, 5),
        _xfer(705, 1, 0, 5),
        _xfer(706, 1, U128_MAX, 5),
        _xfer(707, 3, 3, 5),
        _xfer(708, 1, 2, 5, pending_id=9),
        _xfer(709, 1, 2, 5, timeout=9),
        _xfer(710, 1, 2, 5, ledger=0),
        _xfer(711, 1, 2, 5, code=0),
        _xfer(712, 999, 2, 5),
        _xfer(713, 1, 998, 5),
        _xfer(714, 1, 41, 5),                       # different ledgers
        _xfer(715, 41, 42, 5),                      # ledger vs accounts
        _xfer(716, 45, 2, 5),                       # debit closed
        _xfer(717, 2, 45, 5),                       # credit closed
        _xfer(718, 1, 2, 5, timestamp=9),
        _xfer(719, 1, 2, 0),                        # zero amount is valid
        _xfer(720, 1, 2, 5, flags=TF.pending, timeout=2**32 - 1),
    ]
    out = pr.transfers(batch)
    assert not bool(out["fallback"])


def test_overflows_timeout_near_the_top_of_the_clock():
    pr = Pair(ts=(1 << 63) - (1 << 61))
    pr.accounts([_acct(1), _acct(2)])
    out = pr.transfers([
        _xfer(800, 1, 2, 5, flags=TF.pending, timeout=2**32 - 1),
        _xfer(801, 1, 2, 5, flags=TF.pending, timeout=1)])
    assert not bool(out["fallback"])


def test_u128_edge_amounts_and_the_overflow_proof():
    pr = _ledger_pair()
    big = [_xfer(900, 1, 2, 1 << 126), _xfer(901, 3, 4, (1 << 126) - 1),
           _xfer(902, 5, 6, (1 << 64) - 1),
           _xfer(903, 7, 8, (1 << 96) - 1),
           _xfer(904, 1, 3, (1 << 125) + (1 << 64) + 1, flags=TF.pending)]
    out = pr.transfers(big)
    assert not bool(out["fallback"])
    # Pair sums plus the batch sum would reach 2^128: the E4 proof fails.
    out = pr.transfers([_xfer(905, 1, 2, 1 << 127),
                        _xfer(906, 2, 1, 1 << 127)])
    assert bool(out["fallback"])
    # Max-amount sentinels on failing lanes do not trip the proof.
    out = pr.transfers([_xfer(907, 0, 0, U128_MAX, pending_id=12345,
                              flags=TF.post_pending_transfer),
                        _xfer(908, 9, 10, 3)])
    assert not bool(out["fallback"])


@pytest.mark.parametrize("case", [
    "imported", "balancing", "closing", "duplicate_id", "in_batch_pending",
    "limit_breach", "forced"])
def test_fallback_batches_leave_state_unchanged(case):
    pr = _ledger_pair()
    P, POST = TF.pending, TF.post_pending_transfer
    pr.transfers([_xfer(1100, 47, 46, 50)])   # headroom 50 on 46
    ok = [_xfer(1200 + i, 1 + i, 2 + i, 10) for i in range(5)]
    extra = {}
    if case == "imported":
        bad = [_xfer(1300, 1, 2, 5, flags=TF.imported, timestamp=TS0)]
    elif case == "balancing":
        bad = [_xfer(1300, 1, 2, 5, flags=TF.balancing_debit)]
    elif case == "closing":
        bad = [_xfer(1300, 1, 2, 5, flags=P | TF.closing_debit)]
    elif case == "duplicate_id":
        bad = [_xfer(1300, 1, 2, 5), _xfer(1300, 3, 4, 5)]
    elif case == "in_batch_pending":
        bad = [_xfer(1300, 1, 2, 5, flags=P),
               _xfer(1301, 0, 0, 0, pending_id=1300, flags=POST)]
    elif case == "limit_breach":
        bad = [_xfer(1300, 46, 1, 30), _xfer(1301, 46, 2, 30)]
    else:
        bad = []
        extra["force_fallback"] = True
    out = pr.transfers(ok + bad, **extra)
    assert bool(out["fallback"])


def test_non_plain_tiers_raise_not_implemented():
    state = JL.init_state(64, 256)
    t_state = state_from_numpy(_np(state), "cpu")
    ev = events_to_device(JL.pad_transfer_events(
        JB.transfers_to_arrays([_xfer(1, 1, 2, 3)]), 16), "cpu")
    # The limit fixpoint tiers are ported: limit_rounds > 1 runs.
    for rounds in (TFK.LIMIT_FIXPOINT_ROUNDS,
                   TFK.LIMIT_FIXPOINT_ROUNDS_DEEP):
        _, out = TFK.create_transfers_fast(t_state, ev, TS0, 1,
                                           limit_rounds=rounds)
        assert not bool(out["fallback"]) and int(out["fix_rounds"]) == 1
    for kw in ({"per_event": {}}, {"seg": {}}, {"ring_reset": True},
               {"imported_mode": True}, {"balancing_mode": True}):
        for rounds in (1, TFK.LIMIT_FIXPOINT_ROUNDS):
            with pytest.raises(NotImplementedError, match="later slice"):
                TFK.create_transfers_fast(t_state, ev, TS0, 1,
                                          limit_rounds=rounds, **kw)
    with pytest.raises(NotImplementedError, match="later slice"):
        TFK.per_event_status(t_state, ev, ev["ts"], imported_ctx={})
    aev = events_to_device(JL.pad_account_events(
        JB.accounts_to_arrays([_acct(1)]), 16), "cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        TFK.create_accounts_fast(t_state, aev, TS0, 1, imported_mode=True)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_random_mixed_batches(seed):
    """Seeded random batches mixing regular transfers, pendings with and
    without timeouts, posts and voids of earlier pendings, linked runs,
    failing lanes and wide amounts."""
    pr = _ledger_pair()
    rng = np.random.default_rng(seed)
    P, POST, VOID, L = (TF.pending, TF.post_pending_transfer,
                        TF.void_pending_transfer, TF.linked)
    pendings = []
    next_id = 10_000
    for b in range(4):
        batch = []
        used_pids = set()
        for _ in range(int(rng.integers(60, 120))):
            next_id += 1
            kind = rng.random()
            dr, cr = (int(v) for v in rng.choice(np.arange(1, 45), 2,
                                                 replace=False))
            shift = int(rng.choice([0, 40, 90]))
            amount = int(rng.integers(1, 1 << 20)) << shift
            flags = L if rng.random() < 0.12 else 0
            if kind < 0.55:
                batch.append(_xfer(next_id, dr, cr, amount, flags=flags,
                                   ledger=1 + (dr > 40)))
            elif kind < 0.75:
                batch.append(_xfer(next_id, dr, cr, amount,
                                   flags=flags | P,
                                   timeout=int(rng.choice([0, 0, 1, 50])),
                                   ledger=1 + (dr > 40)))
                pendings.append(next_id)
            elif kind < 0.9 and pendings:
                pid = int(rng.choice(pendings[:-1] or pendings))
                if pid in used_pids or pid in {t.id for t in batch}:
                    continue
                used_pids.add(pid)
                pv = POST if rng.random() < 0.6 else VOID
                amt = int(rng.choice([0, U128_MAX, 1, 10**7]))
                batch.append(_xfer(next_id, 0, 0, amt, flags=flags | pv,
                                   pending_id=pid, ledger=0, code=0))
            else:
                bad = dict(
                    dr=int(rng.choice([0, 999, 45, dr])),
                    cr=int(rng.choice([cr, 998, 45])),
                    code=int(rng.choice([0, 1])))
                batch.append(_xfer(next_id, bad["dr"], bad["cr"], amount,
                                   code=bad["code"], flags=flags))
        # A pending created in this batch may not be posted in it (that is
        # the fixpoint tiers' in-window join): keep later batches' pids to
        # pendings of earlier batches by construction above.
        pr.transfers(batch, ts_gap=int(rng.integers(5, 2 * 10**9)))
