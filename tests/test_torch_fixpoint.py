"""Port parity: the limit fixpoint tiers of create_transfers.

Each workload batch runs from the same pre-state through the JAX
package's `create_transfers_fixpoint_jit` (8 rounds) and
`create_transfers_fixpoint_deep_jit` (32 rounds) and through the port's
`create_transfers_fixpoint` and `create_transfers_fixpoint_deep` (the
JAX state carried over with `state_from_numpy`). Compared exactly, on
both tiers: r_status, r_ts, fallback, limit_only, limit_hit,
fix_unconverged, fix_rounds, created_count, fb_causes, the state digest,
and every live row of the accounts, balances, transfers and event-ring
matrices and of both hash tables. A batch that falls back must leave the
port's state exactly as it was. The pair then continues from the deep
tier's state (the deep tier resolves whatever the shallow one does).

One pad bucket for the whole file, so each JAX tier compiles once.
"""

import jax
import jax.numpy as jnp
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

A_CAP = 256
T_CAP = 2048
N_PAD = 128
TS0 = 10_000_000_000_000
U128_MAX = (1 << 128) - 1
P, POST, VOID, L = (TF.pending, TF.post_pending_transfer,
                    TF.void_pending_transfer, TF.linked)
DR_LIMIT = AF.debits_must_not_exceed_credits
CR_LIMIT = AF.credits_must_not_exceed_debits

_jit_accounts = jax.jit(JFK.create_accounts_fast)
TIERS = {
    "fixpoint": (JFK.create_transfers_fixpoint_jit,
                 TFK.create_transfers_fixpoint),
    "deep": (JFK.create_transfers_fixpoint_deep_jit,
             TFK.create_transfers_fixpoint_deep),
}
OUT_KEYS = ("fallback", "limit_only", "limit_hit", "fix_unconverged",
            "fix_rounds", "created_count")


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
    """A JAX ledger state stepped by the JAX fixpoint tiers, with every
    batch also run by the port's tiers from the same pre-state."""

    def __init__(self, ts=TS0):
        self.js = JL.init_state(A_CAP, T_CAP)
        self.ts = ts

    def accounts(self, accounts, ts_gap=3):
        n = len(accounts)
        self.ts += n + ts_gap
        ev = JL.pad_account_events(JB.accounts_to_arrays(accounts), N_PAD)
        self.js, out = _jit_accounts(self.js, ev, np.uint64(self.ts),
                                     np.int32(n))
        assert not bool(out["fallback"])

    def transfers(self, events, ts_gap=7):
        """Run the batch on both tiers; returns {tier: port out}."""
        n = len(events)
        self.ts += n + ts_gap
        ev = JL.pad_transfer_events(JB.transfers_to_arrays(events), N_PAD)
        pre = _np(self.js)
        outs = {}
        for tier, (jfn, tfn) in TIERS.items():
            j_in = jax.tree_util.tree_map(jnp.asarray, pre)
            j_state, j_out = jfn(j_in, ev, np.uint64(self.ts), np.int32(n))
            t_state, t_out = tfn(state_from_numpy(pre, "cpu"),
                                 events_to_device(ev, "cpu"), self.ts, n)
            j_out = _np(j_out)
            np.testing.assert_array_equal(
                t_out["r_status"].numpy(), j_out["r_status"].astype(np.int64),
                err_msg=tier)
            np.testing.assert_array_equal(
                t_out["r_ts"].numpy().view(np.uint64), j_out["r_ts"],
                err_msg=tier)
            for k in OUT_KEYS:
                assert int(t_out[k]) == int(j_out[k]), (tier, k)
            assert ({k: bool(v) for k, v in t_out["fb_causes"].items()}
                    == {k: bool(v) for k, v in j_out["fb_causes"].items()})
            got = state_to_numpy(t_state)
            _assert_states_equal(got, _np(j_state))
            assert device_state_digest(t_state) == jax_digest(j_state)
            if bool(j_out["fallback"]):
                _assert_states_equal(got, pre)
            outs[tier] = t_out
        self.js = j_state
        return outs


def _acct(i, **kw):
    kw.setdefault("ledger", 1)
    kw.setdefault("code", 1)
    return Account(id=i, **kw)


def _xfer(i, dr=0, cr=0, amount=0, **kw):
    kw.setdefault("ledger", 1)
    kw.setdefault("code", 1)
    return Transfer(id=i, debit_account_id=dr, credit_account_id=cr,
                    amount=amount, **kw)


def _names(out):
    from tigerbeetle_tpu_torch.types import CreateTransferStatus
    return [CreateTransferStatus(int(s)).name
            for s in out["r_status"].tolist() if s]


def _funded(accounts, fund=()):
    """A pair with `accounts` created and each (dr, cr, amount) of
    `fund` applied as one batch."""
    pr = Pair()
    pr.accounts(accounts)
    if fund:
        outs = pr.transfers([_xfer(900 + i, dr, cr, amt)
                             for i, (dr, cr, amt) in enumerate(fund)])
        assert not bool(outs["deep"]["fallback"])
    return pr


def _limit_pair():
    return _funded([_acct(1, flags=DR_LIMIT), _acct(2)], fund=[(2, 1, 100)])


# ----------------------------------------- the cases of test_limit_fixpoint

def test_simple_breach_resolved():
    outs = _limit_pair().transfers([_xfer(1, 1, 2, 60), _xfer(2, 1, 2, 60)])
    assert _names(outs["fixpoint"])[:2] == ["created", "exceeds_credits"]
    assert bool(outs["fixpoint"]["limit_hit"])


def test_mid_batch_void_relief():
    pr = _limit_pair()
    pr.transfers([_xfer(10, 1, 2, 50, flags=P)])
    outs = pr.transfers([_xfer(11, pending_id=10, flags=VOID),
                         _xfer(12, 1, 2, 90)])
    assert _names(outs["fixpoint"]) == ["created", "created"]


def test_cascade_failure_frees_room():
    outs = _limit_pair().transfers([_xfer(20, 1, 2, 80), _xfer(21, 1, 2, 80),
                                    _xfer(22, 1, 2, 15)])
    assert _names(outs["fixpoint"]) == ["created", "exceeds_credits",
                                        "created"]


def test_chain_rollback_interacts_with_limits():
    pr = _funded([_acct(1, flags=DR_LIMIT), _acct(3, flags=DR_LIMIT),
                  _acct(2)], fund=[(2, 1, 100), (2, 3, 100)])
    outs = pr.transfers([_xfer(30, 1, 2, 150, flags=L), _xfer(31, 3, 2, 70),
                         _xfer(32, 3, 2, 70)])
    assert _names(outs["fixpoint"]) == ["exceeds_credits",
                                        "linked_event_failed", "created"]


def test_credit_side_limit():
    pr = _funded([_acct(1), _acct(2, flags=CR_LIMIT)], fund=[(2, 1, 40)])
    outs = pr.transfers([_xfer(40, 1, 2, 30), _xfer(41, 1, 2, 30)])
    assert _names(outs["fixpoint"]) == ["created", "exceeds_debits"]


def test_randomized_limit_heavy():
    rng = np.random.default_rng(17)
    accounts = [_acct(i, flags=DR_LIMIT if i % 3 == 0 else
                      (CR_LIMIT if i % 3 == 1 else 0)) for i in range(1, 17)]
    pr = _funded(accounts, fund=[(2, i, 200) for i in range(3, 16, 3)])
    next_id = 1000
    for _ in range(4):
        events = []
        for _ in range(64):
            dr, cr = (int(v) for v in rng.integers(1, 17, 2))
            if dr == cr:
                cr = dr % 16 + 1
            events.append(_xfer(next_id, dr, cr, int(rng.integers(1, 120)),
                                flags=L if rng.random() < 0.1 else 0))
            next_id += 1
        events[-1].flags = 0
        pr.transfers(events, ts_gap=100)


# ------------------------------ the in-batch cases of test_inwindow_pending

def _accounts_pair():
    return _funded([_acct(i) for i in range(1, 101)])


INWINDOW = {
    "pend_then_post": [
        _xfer(1000, 1, 2, 100, flags=P, timeout=60), _xfer(1001, 3, 4, 5),
        _xfer(1002, pending_id=1000, amount=U128_MAX, flags=POST)],
    "pend_then_void_sentinel": [
        _xfer(2000, 1, 2, 77, flags=P, timeout=9),
        _xfer(2001, pending_id=2000, flags=VOID)],
    "post_of_failed_pend": [
        _xfer(3000, 1, 999, 10, flags=P),
        _xfer(3001, pending_id=3000, amount=U128_MAX, flags=POST)],
    "post_before_pend": [
        _xfer(4001, pending_id=4000, amount=U128_MAX, flags=POST),
        _xfer(4000, 1, 2, 10, flags=P)],
    "post_of_chain_rolled_back_pend": [
        _xfer(5000, 1, 2, 10, flags=P | L), _xfer(5001, 1, 999, 1),
        _xfer(5002, pending_id=5000, amount=U128_MAX, flags=POST)],
    "use_is_own_chains_first_failure": [
        _xfer(9100, 1, 2, 10, flags=P | L),
        _xfer(9101, pending_id=9100, amount=50, flags=VOID)],
    "post_of_post": [
        _xfer(6000, 1, 2, 10, flags=P),
        _xfer(6001, pending_id=6000, amount=U128_MAX, flags=POST),
        _xfer(6002, pending_id=6001, amount=U128_MAX, flags=POST)],
    "partial_post": [
        _xfer(8000, 1, 2, 100, flags=P),
        _xfer(8001, pending_id=8000, amount=40, flags=POST)],
    "ud_and_ledger_inheritance": [
        _xfer(9000, 1, 2, 10, user_data_128=7, user_data_64=8,
              user_data_32=9, code=3, flags=P),
        _xfer(9001, pending_id=9000, amount=U128_MAX, ledger=0, code=0,
              flags=POST)],
}
INWINDOW_EXPECT = {
    "pend_then_post": ["created"] * 3,
    "pend_then_void_sentinel": ["created"] * 2,
    "post_of_failed_pend": ["credit_account_not_found",
                            "pending_transfer_not_found"],
    "post_before_pend": ["pending_transfer_not_found", "created"],
    "post_of_chain_rolled_back_pend": [
        "linked_event_failed", "credit_account_not_found",
        "pending_transfer_not_found"],
    "use_is_own_chains_first_failure": [
        "linked_event_failed", "exceeds_pending_transfer_amount"],
    "post_of_post": ["created", "created", "pending_transfer_not_pending"],
    "partial_post": ["created"] * 2,
    "ud_and_ledger_inheritance": ["created"] * 2,
}


@pytest.mark.parametrize("case", sorted(INWINDOW))
def test_in_batch_pending(case):
    outs = _accounts_pair().transfers(INWINDOW[case])
    assert _names(outs["fixpoint"]) == INWINDOW_EXPECT[case]
    assert not bool(outs["fixpoint"]["fallback"])


def test_limits_with_in_batch_releases():
    pr = _funded([_acct(1, flags=DR_LIMIT), _acct(2)], fund=[(2, 1, 100)])
    events = []
    for k in range(12):
        events.append(_xfer(10_000 + 2 * k, 1, 2, 60, flags=P))
        events.append(_xfer(10_001 + 2 * k, pending_id=10_000 + 2 * k,
                            flags=VOID))
    outs = pr.transfers(events)
    assert not bool(outs["deep"]["fallback"])


# ------------------------------------------------------- closing, cascades

def test_closing_flags_and_a_void_of_a_closing_pending():
    pr = _accounts_pair()
    CD, CC = TF.closing_debit, TF.closing_credit
    # Committed closing pendings: accounts 5 and 7 closed, 6 and 8 not.
    first = pr.transfers([_xfer(100, 5, 6, 10, flags=P | CD),
                          _xfer(101, 8, 7, 10, flags=P | CC),
                          _xfer(102, 9, 10, 10)])
    assert _names(first["fixpoint"]) == ["created"] * 3
    outs = pr.transfers([
        _xfer(110, 5, 11, 1),                         # debit closed
        _xfer(111, pending_id=100, flags=VOID),       # reopens 5
        _xfer(112, 5, 11, 1),                         # now passes
        _xfer(113, 12, 13, 5, flags=P | CD),          # closes 12 in batch
        _xfer(114, 12, 14, 1),                        # debit closed
        _xfer(115, pending_id=113, flags=VOID),       # in-batch void reopens
        _xfer(116, 12, 14, 1),                        # passes again
        _xfer(117, 14, 7, 1),                         # credit closed
        _xfer(118, 15, 16, 1, flags=CD),              # must be pending
        _xfer(119, pending_id=101, flags=POST),       # post keeps 7 closed
    ])
    assert _names(outs["fixpoint"]) == [
        "debit_account_already_closed", "created", "created", "created",
        "debit_account_already_closed", "created", "created",
        "credit_account_already_closed",
        "closing_transfer_must_be_pending", "credit_account_already_closed"]


def _cascade_events(k_chains, first_id=10_000):
    """k linked pairs forming a k-wave limit cascade (the construction of
    tests/test_fixpoint_escalation.py): chain k debits limited L_{k+1}
    by 20, credits L_{k+2} by 10; chain 0's credit is poisoned."""
    events = []
    tid = first_id
    for k in range(k_chains):
        poison = 999_999 if k == 0 else 3 + k
        events.append(_xfer(tid, 2 + k, 1, 20, flags=L))
        events.append(_xfer(tid + 1, 1, poison, 10))
        tid += 2
    return events


@pytest.mark.parametrize("k_chains", [4, 12])
def test_limit_cascade(k_chains):
    n_limited = k_chains + 4
    pr = _funded([_acct(1)] + [_acct(i, flags=DR_LIMIT)
                               for i in range(2, n_limited + 2)],
                 fund=[(1, i, 10) for i in range(2, n_limited + 2)])
    outs = pr.transfers(_cascade_events(k_chains))
    deep = outs["deep"]
    assert not bool(deep["fallback"])
    if k_chains == 4:
        assert not bool(outs["fixpoint"]["fallback"])
        assert int(outs["fixpoint"]["fix_rounds"]) == k_chains
    else:
        assert bool(outs["fixpoint"]["fix_unconverged"])
        assert int(outs["fixpoint"]["fix_rounds"]) == 8
        assert int(deep["fix_rounds"]) < 32


def test_bit_edge_ids_and_pids():
    pr = _accounts_pair()
    top = (1 << 64) - 1
    edges = [1 << 63, top, (1 << 63) << 64, top << 64, (top << 64) | top - 1,
             ((1 << 63) << 64) | (1 << 63)]
    events = []
    for k, pid in enumerate(edges):
        events.append(_xfer(pid, 1 + k, 20 + k, 10 + k, flags=P))
    for k, pid in enumerate(edges):
        events.append(_xfer(pid ^ 0x5A5A, pending_id=pid,
                            flags=POST if k % 2 else VOID))
    outs = pr.transfers(events)
    assert _names(outs["fixpoint"]) == ["created"] * 12


@pytest.mark.parametrize("case", ["duplicate_id", "double_post",
                                  "double_post_of_committed"])
def test_duplicates_fall_back_with_state_unchanged(case):
    pr = _accounts_pair()
    pr.transfers([_xfer(50, 1, 2, 10, flags=P)])
    if case == "duplicate_id":
        batch = [_xfer(60, 1, 2, 5), _xfer(61, 3, 4, 5), _xfer(60, 5, 6, 5)]
    elif case == "double_post":
        batch = [_xfer(7000, 1, 2, 10, flags=P),
                 _xfer(7001, pending_id=7000, amount=U128_MAX, flags=POST),
                 _xfer(7002, pending_id=7000, flags=VOID)]
    else:
        batch = [_xfer(70, pending_id=50, flags=POST),
                 _xfer(71, pending_id=50, flags=VOID)]
    outs = pr.transfers(batch)
    for out in outs.values():
        assert bool(out["fallback"]) and bool(out["fb_causes"]["e2_collision"])
        assert not bool(out["fix_unconverged"])


# ------------------------------------------- the join at the largest pad

JOIN_N = 8192   # the ledger's largest pad bucket (N_PAD)


def _join_lanes(seed, dup):
    """Id and pid lanes of a JOIN_N-lane batch whose keys sit on the u64
    bit edges (2^63, 2^64 - 1 in either half): definitions, uses of
    earlier and of later definitions, uses of keys never defined, and
    padding lanes. `dup` adds one same-kind duplicate (a second use of
    one pending id)."""
    rng = np.random.default_rng(seed)
    top, half = (1 << 64) - 1, 1 << 63
    halves = np.array([0, 1, half - 1, half, half + 1, top - 1, top],
                      dtype=np.uint64)
    keys = set()
    while len(keys) < JOIN_N:
        keys.add((int(rng.choice(halves)) if rng.random() < 0.5
                  else int(rng.integers(0, 1 << 64, dtype=np.uint64)),
                  int(rng.choice(halves))))
    keys = sorted(keys - {(0, 0)}, key=lambda _: rng.random())
    ids = np.zeros((JOIN_N, 2), dtype=np.uint64)   # 8 lanes with no id
    ids[:JOIN_N - 8] = keys[:JOIN_N - 8]
    is_pv = rng.random(JOIN_N) < 0.5
    # Each use names a distinct definition: earlier, later or absent.
    pid = np.zeros((JOIN_N, 2), dtype=np.uint64)
    targets = rng.permutation(JOIN_N - 8)[:int(is_pv.sum())]
    pid[is_pv] = ids[targets]
    absent = is_pv & (rng.random(JOIN_N) < 0.1)
    pid[absent, 0] = np.uint64(half)
    pid[absent, 1] = rng.integers(1 << 40, 1 << 41, int(absent.sum()),
                                  dtype=np.uint64)
    if dup:
        uses = np.flatnonzero(is_pv & ~absent)
        pid[uses[-1]] = pid[uses[0]]
    valid = np.ones(JOIN_N, dtype=bool)
    valid[-3:] = False
    ev = {"id_hi": ids[:, 0], "id_lo": ids[:, 1],
          "pid_hi": pid[:, 0], "pid_lo": pid[:, 1]}
    return ev, valid, is_pv


@pytest.mark.parametrize("dup", [False, True])
def test_join_at_the_largest_pad(dup):
    """The port's successive stable sorts and its packed run fill give the
    JAX package's one variadic sort's (dups, inwin, didx), with keys on
    the u64 bit edges and run ids up to the largest pad."""
    ev, valid, pv = _join_lanes(11 + dup, dup)
    j_fn = jax.jit(JFK._dup_and_pend_join, static_argnums=4)
    j_dups, j_inwin, j_didx = _np(j_fn(
        {k: jnp.asarray(v) for k, v in ev.items()}, jnp.asarray(valid),
        jnp.asarray(pv), jnp.arange(JOIN_N, dtype=jnp.int32), JOIN_N))
    t_dups, t_inwin, t_didx = TFK._dup_and_pend_join(
        {k: torch.from_numpy(v.view(np.int64)) for k, v in ev.items()},
        torch.from_numpy(valid), torch.from_numpy(pv),
        torch.arange(JOIN_N, dtype=torch.int64), JOIN_N)
    assert bool(t_dups) == bool(j_dups) == dup
    np.testing.assert_array_equal(t_inwin.numpy(), j_inwin)
    np.testing.assert_array_equal(t_didx.numpy(), j_didx.astype(np.int64))
    assert 1000 < int(j_inwin.sum()) < int(pv.sum())
