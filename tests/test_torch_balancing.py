"""Port parity: the balancing tiers, on the CPU.

Kernel level: each batch runs from the same pre-state through the JAX
package's `create_transfers_balancing_jit` (8 rounds) and
`create_transfers_balancing_deep_jit` (32 rounds), and windows through
`create_transfers_super_balancing_jit` and its `_ring` variant (24
rounds), and through the port's counterparts. Compared exactly:
statuses, timestamps, the fallback / convergence / cause flags, the
rounds consumed, created counts, every live row of the state and of both
hash tables, and the digest; a batch that no tier falls back on also
runs on the oracle, whose statuses, timestamps and digest the port must
give.

Ledger level: the port's DeviceLedger, the JAX package's and the oracle
fed the same traffic: the same results, digests and ladder, route and
cause counters, per batch (the balancing ladder and its deep-first
regime) and as windows (super_balancing, synchronous, all-or-nothing
and pipelined).

The cases are those of the JAX package's tests/test_balancing_native.py
and the closing x balancing case of tests/test_closing_native.py.
Inputs are made with numpy from a seed; the kernels run at one pad
bucket (128), the ledgers at 1024.
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
L_A_CAP = 1 << 12
L_T_CAP = 1 << 14
DR_LIMIT = int(AF.debits_must_not_exceed_credits)
CR_LIMIT = int(AF.credits_must_not_exceed_debits)
LINKED = int(TF.linked)
PENDING = int(TF.pending)
POST = int(TF.post_pending_transfer)
VOID = int(TF.void_pending_transfer)
BAL_DR = int(TF.balancing_debit)
BAL_CR = int(TF.balancing_credit)
CLOSE_DR = int(TF.closing_debit)
CLOSE_CR = int(TF.closing_credit)
IMP = int(TF.imported)
AMOUNT_MAX = (1 << 128) - 1

TIERS = {
    "balancing": (JFK.create_transfers_balancing_jit,
                  TFK.create_transfers_balancing),
    "deep": (JFK.create_transfers_balancing_deep_jit,
             TFK.create_transfers_balancing_deep),
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


def _x(i, dr=0, cr=0, amount=0, flags=0, **kw):
    return Transfer(id=i, debit_account_id=dr, credit_account_id=cr,
                    amount=amount, ledger=1, code=1, flags=flags, **kw)


def _accts(n, flags=None):
    flags = flags or {}
    return [Account(id=i, ledger=1, code=1, flags=flags.get(i, 0))
            for i in range(1, n + 1)]


class KPair:
    """A JAX ledger state and the oracle, stepped together; every batch
    also runs through the port's balancing tiers from the same
    pre-state."""

    def __init__(self, accounts, fund=()):
        self.js = JL.init_state(A_CAP, T_CAP)
        self.sm = StateMachineOracle()
        n = len(accounts)
        ev = JL.pad_account_events(JB.accounts_to_arrays(accounts), N_PAD)
        self.js, out = _jit_accounts(self.js, ev, np.uint64(100),
                                     np.int32(n))
        assert not bool(out["fallback"])
        self.sm.create_accounts(accounts, 100)
        self.ts = 10**12
        for i, (dr, cr, amt) in enumerate(fund):
            self.transfers([_x(900 + i, dr, cr, amt)])

    def transfers(self, events, tiers=tuple(TIERS)):
        """Run the batch on each tier; returns (oracle statuses or None
        when every tier fell back, {tier: port out})."""
        n = len(events)
        self.ts += n + 10
        ts = self.ts
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
            _assert_states_equal(got, _np(j_state))
            assert device_state_digest(t_state) == jax_digest(j_state)
            outs[tier] = t_out
            if bool(j_out["fallback"]):
                _assert_states_equal(got, pre)
            else:
                done[tier] = (t_state, t_out)
                nxt = nxt or j_state
        if nxt is None:
            return None, outs
        self.js = nxt
        want = self.sm.create_transfers(events, ts)
        digest = oracle_state_digest(self.sm, A_CAP)
        for tier, (t_state, t_out) in done.items():
            assert ([int(s) for s in t_out["r_status"][:n].tolist()]
                    == [int(r.status) for r in want]), tier
            assert ([int(t) for t in t_out["r_ts"][:n].tolist()]
                    == [r.timestamp for r in want]), tier
            assert device_state_digest(t_state) == digest, tier
        return [r.status.name for r in want], outs

    def amounts(self, ids):
        return [t.amount for t in self.sm.lookup_transfers(ids)]


def _three():
    return _accts(3)


# ------------------------------------------------- per batch, kernel level

def test_amount_max_clamps_to_headroom():
    pair = KPair(_three(), fund=[(2, 1, 100)])
    names, _ = pair.transfers([_x(1, 1, 3, AMOUNT_MAX, BAL_DR)])
    assert names == ["created"] and pair.amounts([1]) == [100]


def test_in_batch_cascade():
    pair = KPair(_three(), fund=[(2, 1, 100)])
    names, outs = pair.transfers([_x(1, 1, 3, 60, BAL_DR),
                                  _x(2, 1, 3, AMOUNT_MAX, BAL_DR),
                                  _x(3, 1, 3, AMOUNT_MAX, BAL_DR)])
    assert names == ["created"] * 3
    assert pair.amounts([1, 2, 3]) == [60, 40, 0]
    assert not bool(outs["balancing"]["limit_hit"])


def test_balancing_credit():
    pair = KPair(_three(), fund=[(1, 2, 80)])
    names, _ = pair.transfers([_x(1, 3, 1, AMOUNT_MAX, BAL_CR)])
    assert names == ["created"] and pair.amounts([1]) == [80]


def test_both_flags_min_composes():
    pair = KPair(_accts(4), fund=[(2, 1, 100), (3, 4, 30)])
    names, _ = pair.transfers([_x(1, 1, 3, AMOUNT_MAX, BAL_DR | BAL_CR)])
    assert names == ["created"] and pair.amounts([1]) == [30]


def test_balancing_pending_holds_headroom():
    pair = KPair(_three(), fund=[(2, 1, 100)])
    names, _ = pair.transfers([
        _x(1, 1, 3, 70, BAL_DR | PENDING, timeout=60),
        _x(2, 1, 3, AMOUNT_MAX, BAL_DR)])
    assert names == ["created"] * 2 and pair.amounts([1, 2]) == [70, 30]


def test_zero_headroom_zero_amount():
    pair = KPair(_accts(2))
    names, _ = pair.transfers([_x(1, 1, 2, AMOUNT_MAX, BAL_DR)])
    assert names == ["created"] and pair.amounts([1]) == [0]


def test_mid_batch_relief_widens_clamp():
    pair = KPair(_three(), fund=[(2, 1, 100)])
    pair.transfers([_x(800, 1, 3, 90, PENDING, timeout=3600)])
    names, _ = pair.transfers([_x(801, pending_id=800, flags=VOID),
                               _x(1, 1, 3, AMOUNT_MAX, BAL_DR)])
    assert names == ["created"] * 2 and pair.amounts([1]) == [100]


def test_balancing_under_limits():
    pair = KPair(_accts(3, {1: DR_LIMIT, 3: CR_LIMIT}), fund=[(2, 1, 50)])
    names, _ = pair.transfers([_x(1, 1, 3, AMOUNT_MAX, BAL_DR)])
    assert names == ["exceeds_debits"]
    names, _ = pair.transfers([_x(2, 1, 2, AMOUNT_MAX, BAL_DR)])
    assert names == ["created"] and pair.amounts([2]) == [50]


def test_linked_chain_rollback():
    pair = KPair(_three(), fund=[(2, 1, 100)])
    names, _ = pair.transfers([_x(1, 1, 3, AMOUNT_MAX, BAL_DR | LINKED),
                               _x(2, 1, 99, 1)])
    assert names == ["linked_event_failed", "credit_account_not_found"]
    names, _ = pair.transfers([_x(3, 1, 3, AMOUNT_MAX, BAL_DR)])
    assert names == ["created"] and pair.amounts([3]) == [100]


def test_exists_amount_upper_bound():
    pair = KPair(_three(), fund=[(2, 1, 100)])
    pair.transfers([_x(1, 1, 3, AMOUNT_MAX, BAL_DR)])
    got = [pair.transfers([_x(1, 1, 3, amt, BAL_DR)])[0][0]
           for amt in (AMOUNT_MAX, 100, 99)]
    assert got == ["exists", "exists", "exists_with_different_amount"]


def test_inwindow_balancing_pending_def_falls_back():
    """A post of a balancing pending made earlier in the same batch: the
    in-batch view reads the nominal amount, the stored one is the clamp,
    so every balancing tier falls back (e1) with the state untouched."""
    pair = KPair(_three(), fund=[(2, 1, 100)])
    names, outs = pair.transfers([
        _x(1, 1, 3, AMOUNT_MAX, BAL_DR | PENDING, timeout=60),
        _x(2, pending_id=1, amount=AMOUNT_MAX, flags=POST)])
    assert names is None
    assert all(bool(o["fb_causes"]["e1_hard_flags"]) for o in outs.values())


def test_imported_flag_is_hard():
    pair = KPair(_three(), fund=[(2, 1, 100)])
    names, outs = pair.transfers([_x(1, 1, 3, AMOUNT_MAX, BAL_DR),
                                  _x(2, 1, 3, 5, IMP, timestamp=500)])
    assert names is None
    assert all(bool(o["fb_causes"]["e1_hard_flags"]) for o in outs.values())


def test_closing_native_in_balancing_batch():
    pair = KPair(_accts(2), fund=[(2, 1, 10)])
    names, _ = pair.transfers([
        _x(1, 1, 2, AMOUNT_MAX, BAL_DR),
        _x(2, 1, 2, 1, PENDING | CLOSE_DR, timeout=60)])
    assert names == ["created", "created"]


def test_closing_and_balancing_one_batch():
    """tests/test_closing_native.py: closing_credit and balancing_debit in
    one batch share the rounds."""
    pair = KPair(_accts(8), fund=[(6, 2, 50)])
    names, _ = pair.transfers([
        _x(21, 2, 3, AMOUNT_MAX, BAL_DR),
        _x(22, 4, 3, 1, PENDING | CLOSE_CR, timeout=60),
        _x(23, 5, 3, AMOUNT_MAX, BAL_DR),
        _x(24, 3, 5, AMOUNT_MAX, BAL_DR)])
    assert names == ["created", "created", "credit_account_already_closed",
                     "debit_account_already_closed"]


def test_balance_overflow_statuses():
    """The overflow statuses, exact under balancing (the amount-sum proof
    is bypassed there): account 1's credits_posted is filled to
    2^128 - 1, so a credit of 7 overflows, while a balancing debit beside
    it clamps to 0 and creates."""
    pair = KPair(_accts(4), fund=[(2, 1, 1 << 127), (3, 1, (1 << 127) - 1)])
    names, outs = pair.transfers([_x(3, 4, 1, 7), _x(4, 4, 1, 7, BAL_DR),
                                  _x(5, 1, 4, 9, PENDING, timeout=60)])
    assert names == ["overflows_credits_posted", "created", "created"]
    assert not bool(outs["balancing"]["fallback"])
    assert pair.amounts([4]) == [0]


def test_deep_cascade_needs_the_deep_tier():
    """A clamp cascade down a chain of accounts (each balancing debit
    moves what the previous one credited) is deeper than 8 rounds: the
    8-round tier reports it unconverged, the 32-round tier resolves it."""
    n = 14
    pair = KPair(_accts(n), fund=[(n, 1, 1000)])
    names, outs = pair.transfers([_x(10 + i, i + 1, i + 2, AMOUNT_MAX,
                                     BAL_DR) for i in range(n - 2)])
    assert names == ["created"] * (n - 2)
    assert bool(outs["balancing"]["fix_unconverged"])
    assert not bool(outs["deep"]["fallback"])
    assert pair.amounts([10 + i for i in range(n - 2)]) == [1000] * (n - 2)


@pytest.mark.parametrize("seed", [0xBA1A])
def test_seeded_fuzz_differential_kernel(seed):
    """tests/test_balancing_native.py's fuzz (regular, balancing debit /
    credit / both, pending balancing, posts and voids of earlier
    pendings, limit-flagged accounts) on both tiers, batch by batch."""
    rng = np.random.default_rng(seed)
    n_acct = 10
    pair = KPair(_accts(n_acct, {3: DR_LIMIT, 7: CR_LIMIT}),
                 fund=[(2, 1, 500), (4, 3, 400), (6, 5, 300), (8, 7, 200),
                       (10, 9, 100)])
    pool = []
    for events, created_pendings in _fuzz_batches(rng, n_acct, 6, pool):
        names, _ = pair.transfers(events)
        assert names is not None
        pool.extend(e.id for e, nm in zip(events, names)
                    if nm == "created" and e.id in created_pendings)


def _fuzz_batches(rng, n_acct, n_batches, pool):
    """test_balancing_native.py's fuzz batches. A generator: the caller
    adds each batch's created pendings to `pool`, from which later
    batches post and void."""
    next_id = 1000
    for _ in range(n_batches):
        events, created_pendings = [], set()
        for _k in range(24):
            kind = rng.integers(0, 10)
            tid = next_id
            next_id += 1
            if kind <= 1 and pool:
                pid = int(pool.pop(rng.integers(0, len(pool))))
                events.append(_x(tid, pending_id=pid,
                                 flags=POST if kind == 0 else VOID,
                                 amount=AMOUNT_MAX if kind == 0 else 0))
                continue
            dr_i, cr_i = rng.choice(n_acct, size=2, replace=False) + 1
            flags = 0
            if kind in (2, 3):
                flags |= BAL_DR
            elif kind in (4, 5):
                flags |= BAL_CR
            elif kind == 6:
                flags |= BAL_DR | BAL_CR
            amount = int(rng.integers(1, 120))
            if flags and rng.integers(0, 3) == 0:
                amount = AMOUNT_MAX
            if kind == 7:
                flags |= PENDING
                created_pendings.add(tid)
            if flags & (BAL_DR | BAL_CR) and rng.integers(0, 4) == 0:
                flags |= PENDING
                created_pendings.add(tid)
            events.append(_x(tid, int(dr_i), int(cr_i), amount, flags,
                             timeout=3600 if flags & PENDING else 0))
        yield events, created_pendings


# ---------------------------------------------------- windows, kernel level

_WINDOW_TIERS = {
    "super_balancing": (JFK.create_transfers_super_balancing_jit,
                        TFK.create_transfers_super_balancing),
    "super_balancing_ring": (
        JFK.create_transfers_super_balancing_ring_jit,
        lambda s, e, g: TFK.create_transfers_super_balancing(
            s, e, g, ring_reset=True)),
}


@pytest.mark.parametrize("name", sorted(_WINDOW_TIERS))
def test_super_balancing_window_kernel(name):
    """A window of three prepares whose clamps cascade across prepares
    (and one with an in-window balancing pending definition, which falls
    back whole): outputs and state equal the JAX package's, and the
    prepares' results the oracle's."""
    pair = KPair(_accts(6, {3: DR_LIMIT}), fund=[(2, 1, 100), (4, 3, 40)])
    batches = [
        [_x(1, 1, 5, 30, BAL_DR), _x(2, 3, 6, AMOUNT_MAX, BAL_DR)],
        [_x(3, 1, 5, AMOUNT_MAX, BAL_DR | PENDING, timeout=60),
         _x(4, 5, 1, AMOUNT_MAX, BAL_CR)],
        [_x(5, 1, 6, AMOUNT_MAX, BAL_DR), _x(6, 6, 3, 10),
         _x(7, 3, 2, AMOUNT_MAX, BAL_DR)]]
    tss = [pair.ts + 1000 * (b + 1) for b in range(3)]
    jfn, tfn = _WINDOW_TIERS[name]
    for window, falls in ((batches, False),
                          ([[_x(20, 1, 2, AMOUNT_MAX,
                                BAL_DR | PENDING, timeout=60)],
                            [_x(21, pending_id=20, flags=POST,
                                amount=AMOUNT_MAX)], [_x(22, 4, 5, 1)]],
                           True)):
        # Both windows are three prepares: one JAX program a variant.
        ts_w = tss if not falls else [t + 3000 for t in tss]
        ev, seg = JL.stack_superbatch(
            [JB.transfers_to_arrays(b) for b in window], ts_w, N_PAD)
        pre = _np(pair.js)
        j_state, j_out = jfn(jax.tree_util.tree_map(jnp.asarray, pre), ev,
                             seg)
        t_state, t_out = tfn(state_from_numpy(pre, "cpu"),
                             {k: carrier(v, "cpu") for k, v in ev.items()},
                             {k: carrier(v, "cpu") for k, v in seg.items()})
        j_out = _np(j_out)
        _assert_outs_equal(t_out, j_out, name)
        _assert_states_equal(state_to_numpy(t_state), _np(j_state))
        assert bool(j_out["fallback"]) == falls
        if falls:
            _assert_states_equal(state_to_numpy(t_state), pre)
            continue
        pair.js = j_state
        st = t_out["r_status"].numpy().reshape(len(window), N_PAD)
        ts = t_out["r_ts"].numpy().reshape(len(window), N_PAD)
        for b, (batch, t) in enumerate(zip(window, ts_w)):
            want = pair.sm.create_transfers(batch, t)
            assert st[b, :len(batch)].tolist() == [int(r.status)
                                                   for r in want]
            assert ts[b, :len(batch)].tolist() == [r.timestamp for r in want]
        assert device_state_digest(t_state) == oracle_state_digest(pair.sm,
                                                                   A_CAP)


# ------------------------------------------------------------ the ledgers

def _counters(led):
    return dict(
        ladder=(led.fast_batches, led.fixpoint_batches,
                led.deep_fixpoint_batches, led.escalations, led.fallbacks),
        causes=led.fallback_causes, routes=led.window_routes,
        window_fallbacks=led.window_fallbacks,
        last=(led.last_window_route, led.last_window_tier),
        chain_fb=led.chain_batch_fallbacks,
        regimes=(led._fixpoint_first, led._deep_first, led._bal_deep_first))


class Trio:
    """The port's ledger (CPU), the JAX package's and the oracle."""

    def __init__(self, accounts, fund=()):
        self.port = DeviceLedger(a_cap=L_A_CAP, t_cap=L_T_CAP, device="cpu")
        self.jax = JL.DeviceLedger(a_cap=L_A_CAP, t_cap=L_T_CAP)
        self.sm = StateMachineOracle()
        self.port.create_accounts(
            [TT.Account(**dataclasses.asdict(a)) for a in accounts], 100)
        self.jax.create_accounts(accounts, 100)
        self.sm.create_accounts(accounts, 100)
        self.ts = 10**12
        for i, (dr, cr, amt) in enumerate(fund):
            self.transfers([_x(900 + i, dr, cr, amt)])

    def check(self):
        assert (device_state_digest(self.port.state)
                == jax_digest(self.jax.state)
                == oracle_state_digest(self.sm, L_A_CAP))
        assert _counters(self.port) == _counters(self.jax)

    def transfers(self, events):
        self.ts += 10**6
        want = [(r.timestamp, r.status.name)
                for r in self.sm.create_transfers(events, self.ts)]
        got = self.port.create_transfers(
            [TT.Transfer(**dataclasses.asdict(t)) for t in events], self.ts)
        ref = self.jax.create_transfers(events, self.ts)
        assert [(r.timestamp, r.status.name) for r in got] == want
        assert [(r.timestamp, r.status.name) for r in ref] == want
        self.check()
        return [s for _, s in want]

    def window(self, batches, mode="sync"):
        """One window through both ledgers: "sync", "aon" (all or
        nothing) or "pipelined" (submitted, then resolved)."""
        tss = []
        for _ in batches:
            self.ts += 10**6
            tss.append(self.ts)
        evs = [JB.transfers_to_arrays(b) for b in batches]
        want = [[(int(r.status), r.timestamp)
                 for r in self.sm.create_transfers(b, t)]
                for b, t in zip(batches, tss)]
        outs = []
        for led in (self.port, self.jax):
            if mode == "pipelined":
                tk = led.submit_window(evs, tss)
                assert tk is not None
                led.resolve_windows()
                res = tk.results[1]
            else:
                res = led.create_transfers_window(evs, tss, mode == "aon")
            outs.append([list(zip(st.tolist(), ts.tolist()))
                         for st, ts in res])
        assert outs[0] == outs[1] == want
        self.check()


def test_ledger_balancing_ladder_matches_the_jax_ledger():
    """Per batch: balancing batches on the balancing tier (not the
    mirror), the deep escalation of a cascade deeper than 8 rounds and
    the deep-first regime after it, an in-batch balancing pending
    definition that falls back to the mirror; counters and regimes equal
    to the JAX ledger's after every batch."""
    n = 14
    trio = Trio(_accts(n), fund=[(n, 1, 1000)])
    trio.transfers([_x(1, 1, 3, 60, BAL_DR),
                    _x(2, 1, 3, AMOUNT_MAX, BAL_DR)])
    assert trio.port.fixpoint_batches == 1 and trio.port.fallbacks == 0
    trio.transfers([_x(10 + i, i + 1, i + 2, AMOUNT_MAX, BAL_DR)
                    for i in range(n - 2)])
    assert trio.port.escalations == 1 and trio.port._bal_deep_first == 8
    trio.transfers([_x(40, 2, 1, AMOUNT_MAX, BAL_DR)])
    assert trio.port._bal_deep_first == 7
    trio.transfers([_x(41, 1, 3, AMOUNT_MAX, BAL_DR | PENDING, timeout=60),
                    _x(42, pending_id=41, amount=AMOUNT_MAX, flags=POST)])
    assert trio.port.fallbacks == 1
    assert trio.port.fallback_causes == {"e1_hard_flags": 1}


@pytest.mark.parametrize("seed", [0xBA1A, 7])
def test_ledger_seeded_fuzz_differential(seed):
    """The balancing fuzz through the three ledgers: all on the device."""
    rng = np.random.default_rng(seed)
    n_acct = 10
    trio = Trio(_accts(n_acct, {3: DR_LIMIT, 7: CR_LIMIT}),
                fund=[(2, 1, 500), (4, 3, 400), (6, 5, 300), (8, 7, 200),
                      (10, 9, 100)])
    pool = []
    for events, created_pendings in _fuzz_batches(rng, n_acct, 6, pool):
        names = trio.transfers(events)
        pool.extend(e.id for e, nm in zip(events, names)
                    if nm == "created" and e.id in created_pendings)
    assert trio.port.fallbacks == 0 and trio.port.fixpoint_batches > 0


def test_ledger_balancing_windows():
    """Balancing windows take super_balancing: synchronously, all or
    nothing and pipelined (two deep), as the JAX ledger routes them; a
    window with an in-window balancing pending definition falls back
    whole and runs per batch."""
    trio = Trio(_accts(6, {3: DR_LIMIT}), fund=[(2, 1, 100), (4, 3, 40)])
    w1 = [[_x(1, 1, 5, 30, BAL_DR), _x(2, 3, 6, AMOUNT_MAX, BAL_DR)],
          [_x(3, 1, 5, AMOUNT_MAX, BAL_DR | PENDING, timeout=60),
           _x(4, 5, 1, AMOUNT_MAX, BAL_CR)]]
    trio.window(w1)
    assert trio.port.window_routes == {"super_balancing": 1}
    trio.window([[_x(5, 1, 6, AMOUNT_MAX, BAL_DR)],
                 [_x(6, 6, 3, 10), _x(7, 3, 2, AMOUNT_MAX, BAL_DR)]], "aon")
    trio.window([[_x(8, 2, 4, AMOUNT_MAX, BAL_DR)],
                 [_x(9, 4, 2, 5, BAL_CR)]], "pipelined")
    assert trio.port.window_routes == {"super_balancing": 3}
    trio.window([[_x(20, 1, 2, AMOUNT_MAX, BAL_DR | PENDING, timeout=60)],
                 [_x(21, pending_id=20, flags=POST, amount=AMOUNT_MAX)]])
    assert trio.port.window_routes == {"super_balancing": 4, "per_batch": 1}
    assert trio.port.window_fallbacks == 1
