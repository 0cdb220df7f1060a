"""Commit windows, port against the JAX package, on the CPU.

The window kernels (`create_transfers_super`, `_super_deep`, `_chain`
and their ring variants) run the same windows from the same state as
the JAX package's `_create_transfers_super*` / `_create_transfers_chain`
(jitted): statuses, timestamps, fallback flags, created counts, causes,
the whole state (hash tables included) and the digest must be equal.
The ledger's window routes (`create_transfers_window`, `submit_window`
/ `resolve_windows`) run beside the JAX package's DeviceLedger and the
oracle: the same results, the same state digest (on imported windows
the oracle's: see test_imported_window_runs_per_batch), and the same
route counters.

Inputs are made with numpy from a seed: a_cap 2^12, prepares of at most
256 events, one pad bucket (1024), windows of at most 4 prepares, so the
JAX package compiles one program a function and depth.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.oracle import StateMachineOracle
from tigerbeetle_tpu.ops import fast_kernels as JFK
from tigerbeetle_tpu.ops import ledger as JL
from tigerbeetle_tpu.ops.batch import transfers_to_arrays
from tigerbeetle_tpu.ops.state_epoch import device_state_digest as jax_digest
from tigerbeetle_tpu.ops.state_epoch import oracle_state_digest
from tigerbeetle_tpu.types import Account, Transfer
from tigerbeetle_tpu.types import AccountFlags as AF
from tigerbeetle_tpu.types import TransferFlags as TF
from tigerbeetle_tpu_torch import DeviceLedger, state_from_numpy
from tigerbeetle_tpu_torch import state_to_numpy
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.ops import fast_kernels as TFK
from tigerbeetle_tpu_torch.ops import ledger as TL
from tigerbeetle_tpu_torch.ops.state_epoch import device_state_digest
from tigerbeetle_tpu_torch.ops.u64 import carrier
from tigerbeetle_tpu_torch.ops.window_graph import state_signature

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

A_CAP = 1 << 12
T_CAP = 1 << 14
PAD = 1024
TS0 = 10_000_000_000_000
N_ACC = 64
U128_MAX = (1 << 128) - 1


@pytest.fixture(autouse=True)
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _accounts():
    """Accounts 1..N_ACC on ledger 1 (N_ACC closed), two limited ones."""
    accts = [Account(id=i, ledger=1, code=1) for i in range(1, N_ACC + 1)]
    accts[-1].flags = AF.closed
    accts += [Account(id=N_ACC + 1, ledger=1, code=1,
                      flags=AF.debits_must_not_exceed_credits),
              Account(id=N_ACC + 2, ledger=1, code=1,
                      flags=AF.credits_must_not_exceed_debits)]
    return accts


def _x(i, dr=0, cr=0, amount=0, ledger=1, code=1, **kw):
    return Transfer(id=i, debit_account_id=dr, credit_account_id=cr,
                    amount=amount, ledger=ledger, code=code, **kw)


def _uniform(rng, first_id, n, n_acc=N_ACC - 1):
    dr = rng.integers(1, n_acc + 1, n)
    cr = rng.integers(1, n_acc + 1, n)
    cr = np.where(cr == dr, cr % n_acc + 1, cr)
    return [_x(first_id + i, int(dr[i]), int(cr[i]),
               int(rng.integers(1, 10**6))) for i in range(n)]


# Pendings committed before every window (ids 500..519; even ones time
# out after an hour).
_PRE = [_x(500 + i, 1 + i, 30 + i, 100 + i, flags=TF.pending,
           timeout=(3600 if i % 2 == 0 else 0)) for i in range(20)]


def _window(kind, seed=0):
    """(prepares as transfer lists, timestamps) of one window of 3:
    'clean' (regular transfers, failures, pendings, posts and voids of
    the pre-window pendings, a chain left open at a prepare's end, one at
    the next one's head), 'limit' (a limited account breached in prepare
    2), 'refs' (that, and a pending made in prepare 0 posted in prepare
    2) or 'dup' (a repeated id inside prepare 1)."""
    rng = np.random.default_rng(seed)
    p0 = _uniform(rng, 10_000, 120) + [
        _x(10_200, 1, 9999, 5),                        # not found: orphan
        _x(10_201, N_ACC, 2, 5),                       # closed account
        _x(10_202, 3, 4, 77, flags=TF.pending, timeout=60),
        _x(10_203, 5, 6, 7),
        _x(10_204, 5, 6, 7, flags=TF.linked),          # open at the end
    ]
    p1 = [_x(11_000, 7, 8, 3, flags=TF.linked), _x(11_001, 8, 9, 3),
          _x(11_002, pending_id=500, amount=U128_MAX, ledger=0, code=0,
             flags=TF.post_pending_transfer),
          _x(11_003, pending_id=501, ledger=0, code=0,
             flags=TF.void_pending_transfer),
          _x(11_004, pending_id=502, amount=40, ledger=0, code=0,
             flags=TF.post_pending_transfer)] + _uniform(rng, 11_100, 60)
    p2 = _uniform(rng, 12_000, 200) + [
        _x(505, 6, 35, 105, flags=TF.pending),         # exists
        _x(506, 1, 2, 5)]                              # exists, different
    if kind in ("limit", "refs"):
        p2.append(_x(12_501, N_ACC + 1, 1, 9))
    if kind == "refs":
        p2.append(_x(12_500, pending_id=10_202, amount=U128_MAX, ledger=0,
                     code=0, flags=TF.post_pending_transfer))
    if kind == "dup":
        p1.append(_x(11_000, 1, 2, 1))
    batches = [p0, p1, p2]
    tss, ts = [], TS0 + 10_000
    for b in batches:
        ts += len(b) + 100
        tss.append(ts)
    return batches, tss


def _arrays(batches):
    return [transfers_to_arrays(b) for b in batches]


def _pre_state():
    """The JAX ledger state after the accounts and the pre-window
    pendings, fetched to numpy."""
    led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    led.create_accounts(_accounts(), TS0)
    led.create_transfers(_PRE, TS0 + 1000)
    assert led.fast_batches == 2
    return _np(led.state)


def _assert_states_equal(got: dict, want: dict):
    """Port state (numpy) vs JAX state (numpy), dump rows excepted."""
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


_FLAT_OUTS = ("limit_only", "fix_unconverged", "fix_rounds", "limit_hit")


def _assert_outs_equal(t_out, j_out):
    np.testing.assert_array_equal(t_out["r_status"].numpy(),
                                  j_out["r_status"].astype(np.int64))
    np.testing.assert_array_equal(t_out["r_ts"].numpy().view(np.uint64),
                                  j_out["r_ts"])
    for k in ("fallback", "created_count") + _FLAT_OUTS:
        if k in j_out:
            np.testing.assert_array_equal(t_out[k].numpy().astype(np.int64),
                                          j_out[k].astype(np.int64), k)
    assert set(t_out["fb_causes"]) == set(j_out["fb_causes"])
    for k, v in j_out["fb_causes"].items():
        np.testing.assert_array_equal(t_out["fb_causes"][k].numpy(), v, k)


_KERNELS = {
    "super": (JFK.create_transfers_super_jit, TFK.create_transfers_super,
              "flat"),
    "super_ring": (JFK.create_transfers_super_ring_jit,
                   functools.partial(TFK.create_transfers_super,
                                     ring_reset=True), "flat"),
    "super_deep": (JFK.create_transfers_super_deep_jit,
                   TFK.create_transfers_super_deep, "flat"),
    "super_deep_ring": (JFK.create_transfers_super_deep_ring_jit,
                        functools.partial(TFK.create_transfers_super_deep,
                                          ring_reset=True), "flat"),
    "chain": (JFK.create_transfers_chain_jit, TFK.create_transfers_chain,
              "stacked"),
    "chain_ring": (JFK.create_transfers_chain_ring_jit,
                   functools.partial(TFK.create_transfers_chain,
                                     ring_reset=True), "stacked"),
}


def _run_kernel(name, pre, batches, tss, force_fallback=None):
    """One window through the JAX function and the port's from the same
    state; asserts every output and the state equal. Returns the port's
    (state, outs)."""
    jfn, tfn, layout = _KERNELS[name]
    stack = JL.stack_superbatch if layout == "flat" else JL.stack_chain_window
    ev, seg = stack(_arrays(batches), tss, PAD)
    jargs = () if force_fallback is None else (np.bool_(force_fallback),)
    targs = (() if force_fallback is None
             else (torch.tensor(force_fallback),))
    j_state, j_out = jfn(jax.tree_util.tree_map(jax.numpy.asarray, pre),
                         ev, seg, *jargs)
    t_state = state_from_numpy(pre, "cpu")
    t_state, t_out = tfn(
        t_state, {k: carrier(v, "cpu") for k, v in ev.items()},
        {k: carrier(v, "cpu") for k, v in seg.items()}, *targs)
    _assert_outs_equal(t_out, _np(j_out))
    _assert_states_equal(state_to_numpy(t_state), _np(j_state))
    assert device_state_digest(t_state) == jax_digest(j_state)
    return t_state, t_out


@pytest.fixture(scope="module")
def pre():
    return _pre_state()


@pytest.mark.parametrize("kind", ["clean", "limit", "refs", "dup"])
@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_window_kernels_match_the_jax_package(pre, name, kind):
    """Each window kernel on a clean window, one with a limit breach, one
    with the breach and an in-window pending reference (the plain flat
    tier falls back limit_only on both, the deep one resolves them, the
    chain resolves the reference through the state and falls back at the
    breach) and one with a repeated id in its middle prepare (the flat
    tiers fall back whole; the chain commits prepare 0 and poisons
    prepare 2)."""
    batches, tss = _window(kind)
    _, out = _run_kernel(name, pre, batches, tss)
    fb = out["fallback"].numpy()
    if name.startswith("chain"):
        want = {"clean": [0, 0, 0], "limit": [0, 0, 1], "refs": [0, 0, 1],
                "dup": [0, 1, 1]}
        assert fb.tolist() == want[kind]
        if kind == "dup":
            causes = {k: v.tolist() for k, v in out["fb_causes"].items()}
            assert causes["e2_collision"] == [False, True, False]
            assert causes["forced"] == [False, False, True]
    else:
        deep = name.startswith("super_deep")
        assert bool(fb) == (kind == "dup" or (kind != "clean" and not deep))


@pytest.mark.parametrize("name", ["chain_ring", "super"])
def test_a_poisoned_window_leaves_the_state_untouched(pre, name):
    """force_fallback set: every prepare falls back 'forced', nothing is
    written, and the ring variant leaves the ring count as it was."""
    batches, tss = _window("clean")
    state, out = _run_kernel(name, pre, batches, tss, force_fallback=True)
    assert out["fallback"].all() and out["fb_causes"]["forced"].all()
    _assert_states_equal(state_to_numpy(state), pre)


def _sequential(pre, batches, tss):
    """The port's plain tier one prepare at a time: (statuses, ts)."""
    state = state_from_numpy(pre, "cpu")
    got = []
    for b, ts in zip(batches, tss):
        ev = TL.events_to_device(TL.pad_transfer_events(
            transfers_to_arrays(b), PAD), "cpu")
        state, out = TFK.create_transfers_fast(state, ev, ts, len(b))
        assert not bool(out["fallback"])
        got.append((out["r_status"].numpy(), out["r_ts"].numpy()))
    return state, got


def _matches_sequential(pre, name, batches, tss):
    state, out = _run_kernel(name, pre, batches, tss)
    seq_state, seq = _sequential(pre, batches, tss)
    st = out["r_status"].numpy().reshape(len(batches), PAD)
    ts = out["r_ts"].numpy().reshape(len(batches), PAD)
    for b, (s_st, s_ts) in enumerate(seq):
        np.testing.assert_array_equal(st[b], s_st)
        np.testing.assert_array_equal(ts[b], s_ts)
    assert device_state_digest(state) == device_state_digest(seq_state)


@pytest.mark.parametrize("name", ["super", "chain"])
def test_chain_at_boundary_does_not_merge(pre, name):
    """A chain open at a prepare's end fails linked_event_chain_open and
    never absorbs the next prepare's head; a failing chain in the next
    prepare breaks only itself."""
    batches = [[_x(800, 1, 2, 1), _x(801, 1, 2, 1, flags=TF.linked)],
               [_x(810, 3, 4, 1, flags=TF.linked), _x(811, 3, 4, 1)],
               [_x(830, 3, 4, 1, flags=TF.linked), _x(831, 77, 4, 1)]]
    tss = [TS0 + 10_000, TS0 + 20_000, TS0 + 30_000]
    _matches_sequential(pre, name, batches, tss)


def test_cross_batch_duplicate_falls_back(pre):
    """An id repeated across the prepares of a flat window falls the
    window back whole, with the state untouched."""
    batches = [[_x(900, 1, 2, 1)], [_x(900, 1, 2, 1)], [_x(901, 1, 2, 1)]]
    tss = [TS0 + 10_000, TS0 + 20_000, TS0 + 30_000]
    state, out = _run_kernel("super", pre, batches, tss)
    assert bool(out["fallback"]) and bool(out["limit_only"])
    _assert_states_equal(state_to_numpy(state), pre)


@pytest.mark.parametrize("name", ["super", "chain"])
def test_varying_batch_sizes(pre, name):
    rng = np.random.default_rng(13)
    batches = [_uniform(rng, 2000, 1), _uniform(rng, 2100, 37),
               _uniform(rng, 2200, 200)]
    tss = [TS0 + 10_000 + b * (PAD + 10) for b in range(3)]
    _matches_sequential(pre, name, batches, tss)


# ----------------------------------------------------------- the ledgers

class Trio:
    """The port's ledger, the JAX package's and the oracle, fed the same
    accounts and pre-window pendings."""

    def __init__(self):
        self.port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
        self.jax = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
        self.sm = StateMachineOracle()
        accts = _accounts()
        self.port.create_accounts(
            [TT.Account(**dataclasses.asdict(a)) for a in accts], TS0)
        self.jax.create_accounts(accts, TS0)
        self.sm.create_accounts(accts, TS0)
        self.port.create_transfers(
            [TT.Transfer(**dataclasses.asdict(t)) for t in _PRE], TS0 + 1000)
        self.jax.create_transfers(_PRE, TS0 + 1000)
        self.sm.create_transfers(_PRE, TS0 + 1000)

    def oracle(self, batches, tss):
        return [[(int(r.status), r.timestamp)
                 for r in self.sm.create_transfers(b, ts)]
                for b, ts in zip(batches, tss)]

    def check_state(self):
        assert (device_state_digest(self.port.state)
                == jax_digest(self.jax.state)
                == oracle_state_digest(self.sm, A_CAP))
        assert _counters(self.port) == _counters(self.jax)


def _as_pairs(results):
    return [[(int(s), int(t)) for s, t in zip(st.tolist(), ts.tolist())]
            for st, ts in results]


def _counters(led):
    return dict(
        routes=led.window_routes, chain_fb=led.chain_batch_fallbacks,
        last=(led.last_window_route, led.last_window_tier),
        window_fallbacks=led.window_fallbacks,
        ladder=(led.fast_batches, led.fixpoint_batches,
                led.deep_fixpoint_batches, led.escalations, led.fallbacks),
        causes=led.fallback_causes)


@pytest.mark.parametrize("kind,all_or_nothing,route", [
    ("clean", False, {"chain": 1}),
    ("limit", False, {"chain": 1}),
    ("refs", False, {"super_deep": 1}),
    ("dup", False, {"chain": 1, "per_batch": 1}),
    ("clean", True, {"super": 1}),
    ("limit", True, {"super": 1}),
    ("refs", True, {"super_deep": 1}),
    ("dup", True, {"super": 1}),
])
def test_window_routes_match_the_jax_ledger_and_the_oracle(
        kind, all_or_nothing, route):
    """create_transfers_window on each route: the chain (a breach in its
    last prepare replays that prepare per batch, on the fixpoint tier),
    super_deep for an in-window reference, the chain's per-prepare
    fallback (prepare 0 commits, prepare 1 replays per batch, and prepare
    2, re-windowed alone, runs per batch), and all_or_nothing: the flat
    super tier, its escalation to super_deep at a breach, super_deep
    for an in-window reference, and a window that falls back whole
    (None; the caller commits it op by op)."""
    trio = Trio()
    batches, tss = _window(kind)
    want = trio.oracle(batches, tss)
    evs = _arrays(batches)
    got = trio.port.create_transfers_window(evs, tss, all_or_nothing)
    ref = trio.jax.create_transfers_window(evs, tss, all_or_nothing)
    if got is None:
        assert ref is None and kind == "dup"
        got = [trio.port.create_transfers_soa(e, t) for e, t in zip(evs, tss)]
        ref = [trio.jax.create_transfers_soa(e, t) for e, t in zip(evs, tss)]
    assert _as_pairs(got) == _as_pairs(ref) == [
        [(s, t) for s, t in w] for w in want]
    assert trio.port.window_routes == route
    trio.check_state()
    if kind == "dup" and not all_or_nothing:
        assert trio.port.chain_batch_fallbacks == {"e2_collision": 1}
        assert trio.port.window_fallbacks == 1
    if kind == "limit":
        assert trio.port.deep_fixpoint_batches == (3 if all_or_nothing
                                                   else 0)
        assert trio.port.fallbacks == 0


def _drive_pipelined(led, windows):
    """Depth-2 submit/resolve, as the JAX package's serving loop does;
    returns each window's results in order."""
    pending, results = [], []
    for batches, tss in windows:
        evs = _arrays(batches)
        tk = led.submit_window(evs, tss)
        if tk is None:
            led.resolve_windows()
            while pending:
                results.append(pending.pop(0).results[1])
            results.append(led.create_transfers_window(evs, tss))
            continue
        pending.append(tk)
        if len(pending) > 1:
            led.resolve_windows(count=1)
            while pending and pending[0].results is not None:
                results.append(pending.pop(0).results[1])
    led.resolve_windows()
    results.extend(tk.results[1] for tk in pending)
    return results


def _pipe_windows(rng, n_windows, with_pend=False, poison=None, k=3, n=64):
    """The JAX package's test_window_pipeline windows: k prepares of n,
    with_pend posting earlier pendings, `poison` = (window, prepare)
    holding a repeated id."""
    out, pend_pool = [], []
    nid, ts = 10**6, TS0 + 10**6
    for w in range(n_windows):
        batches, tss = [], []
        for b in range(k):
            batch = []
            for i in range(n):
                dr = int(rng.integers(1, N_ACC))
                if with_pend and pend_pool and i % 5 == 0:
                    batch.append(_x(nid, pending_id=pend_pool.pop(0),
                                    amount=U128_MAX,
                                    flags=TF.post_pending_transfer))
                else:
                    f = TF.pending if (with_pend and i % 4 == 0) else 0
                    batch.append(_x(nid, dr, dr % (N_ACC - 1) + 1,
                                    int(rng.integers(1, 100)), flags=f,
                                    timeout=10 if f else 0))
                    if f:
                        pend_pool.append(nid)
                nid += 1
            if poison == (w, b):
                batch[-1] = _x(batch[0].id, 1, 2, 1)
            ts += n + 10
            batches.append(batch)
            tss.append(ts)
        out.append((batches, tss))
    return out


@pytest.mark.parametrize("with_pend,poison", [
    (False, None), (True, None), (False, (1, 1)), (True, (2, 1))])
def test_pipeline_matches_sync(with_pend, poison):
    """Pipelined windows (depth 2, a poisoned successor replays) equal the
    synchronous window path, the JAX package's pipeline and the oracle."""
    windows = _pipe_windows(np.random.default_rng(3), 4, with_pend, poison)
    trio = Trio()
    sync = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    sync.create_accounts([TT.Account(**dataclasses.asdict(a))
                          for a in _accounts()], TS0)
    sync.create_transfers([TT.Transfer(**dataclasses.asdict(t))
                           for t in _PRE], TS0 + 1000)
    got = _drive_pipelined(trio.port, windows)
    ref = _drive_pipelined(trio.jax, windows)
    want = [trio.oracle(b, t) for b, t in windows]
    got_sync = [sync.create_transfers_window(_arrays(b), t)
                for b, t in windows]
    assert ([_as_pairs(w) for w in got] == [_as_pairs(w) for w in ref]
            == [_as_pairs(w) for w in got_sync] == want)
    trio.check_state()
    assert device_state_digest(sync.state) == device_state_digest(
        trio.port.state)
    if poison is not None:
        assert trio.port.fallback_causes.get("e2_collision", 0) >= 1


def test_chain_route_cross_prepare_pend_refs_go_deep():
    """Pendings made in prepare 0 and posted in prepare 1 route the
    pipelined window to super_deep; no fallback, oracle-exact."""
    trio = Trio()
    nid, ts = 5 * 10**6, TS0 + 10**6
    pends = [_x(nid + i, 1 + i % 60, (1 + i) % 60 + 1, 10, flags=TF.pending,
                timeout=1000) for i in range(48)]
    posts = [_x(nid + 100 + i, pending_id=nid + i, amount=U128_MAX,
                ledger=0, code=0, flags=TF.post_pending_transfer)
             for i in range(48)]
    windows = [([pends, posts], [ts + 58, ts + 116])]
    got = _drive_pipelined(trio.port, windows)
    ref = _drive_pipelined(trio.jax, windows)
    want = trio.oracle(*windows[0])
    assert _as_pairs(got[0]) == _as_pairs(ref[0]) == want
    assert trio.port.window_routes == {"super_deep": 1}
    assert trio.port.fallbacks == 0 and trio.port.deep_fixpoint_batches == 2
    trio.check_state()


def test_chain_route_per_batch_fallback_and_poisoning():
    """A repeated id in prepare 1 of window 1: the chain commits prepare 0,
    falls back at prepare 1 (per batch, on the exact path) and poisons
    prepare 2 and window 2, which replay; results, state and counters
    equal the JAX package's pipeline and the oracle."""
    windows = _pipe_windows(np.random.default_rng(17), 3, poison=(1, 1))
    trio = Trio()
    got = _drive_pipelined(trio.port, windows)
    ref = _drive_pipelined(trio.jax, windows)
    want = [trio.oracle(b, t) for b, t in windows]
    assert [_as_pairs(w) for w in got] == [_as_pairs(w) for w in ref] == want
    assert trio.port.chain_batch_fallbacks.get("e2_collision", 0) >= 1
    assert trio.port.fallback_causes["e2_collision"] >= 1
    trio.check_state()


def test_balancing_window_falls_back_per_prepare():
    """A balancing prepare in a window: the window takes the balancing
    window tier (super_balancing), as in the JAX ledger, with no
    per-prepare fallback; results, digest and every route and ladder
    counter equal the JAX package's and the oracle's. (The name is the
    route's before the port had a balancing window tier.)"""
    trio = Trio()
    batches, tss = _window("clean", seed=4)
    batches[1][3] = _x(11_003, 9, 10, 50, flags=TF.balancing_credit)
    want = trio.oracle(batches, tss)
    got = trio.port.create_transfers_window(_arrays(batches), tss)
    ref = trio.jax.create_transfers_window(_arrays(batches), tss)
    assert _as_pairs(got) == _as_pairs(ref) == want
    assert trio.port.window_routes == {"super_balancing": 1}
    assert trio.port.chain_batch_fallbacks == {}
    assert trio.port.fast_batches == 2 + 3 and trio.port.fallbacks == 0
    trio.check_state()


def test_imported_window_runs_per_batch():
    """An imported window takes the imported window tier
    (super_imported), as in the JAX ledger, all_or_nothing too; results
    and every route and ladder counter equal the JAX package's and the
    oracle's. The state is the oracle's: the JAX package's imported tiers
    leave commit_ts at the prepare timestamp, where the oracle and the
    port keep the last imported one; the rest of the JAX ledger's state
    is the port's. (The name is the route's before the port had an
    imported window tier.)"""
    trio = Trio()
    imp = [_x(70_000 + i, 1 + i, 2 + i, 5, flags=TF.imported,
              timestamp=TS0 + 5000 + i) for i in range(8)]
    for aon, batches, tss in (
            (True, [imp[:2], imp[2:4]], [TS0 + 9000, TS0 + 9100]),
            (False, [imp[4:6], imp[6:]], [TS0 + 9200, TS0 + 9300])):
        want = trio.oracle(batches, tss)
        got = trio.port.create_transfers_window(_arrays(batches), tss, aon)
        ref = trio.jax.create_transfers_window(_arrays(batches), tss, aon)
        assert _as_pairs(got) == _as_pairs(ref) == want
    assert trio.port.window_routes == {"super_imported": 2}
    assert _counters(trio.port) == _counters(trio.jax)
    digest = device_state_digest(trio.port.state)
    assert digest == oracle_state_digest(trio.sm, A_CAP)
    assert digest == jax_digest(dict(
        trio.jax.state, commit_ts=jax.numpy.uint64(TS0 + 5007)))
    assert trio.sm.commit_timestamp == TS0 + 5007


# --------------------------------------------------------- in-place state

def test_a_window_leaves_every_state_tensor_in_place():
    """Every route (and a plain batch, an accounts batch) writes the state
    in place: each tensor keeps its storage, which a replayed CUDA graph
    reads and writes."""
    trio = Trio()
    led = trio.port
    sig = state_signature(led.state)
    for kind, aon in (("clean", False), ("refs", False), ("clean", True),
                      ("dup", False)):
        batches, tss = _window(kind, seed=7)
        led.create_transfers_window(_arrays(batches), tss, aon)
        assert state_signature(led.state) == sig, kind
    led.create_accounts([TT.Account(id=900, ledger=1, code=1)], TS0 + 10**8)
    assert state_signature(led.state) == sig
    assert led.fallbacks >= 1 and set(led.window_routes) == {
        "chain", "super_deep", "super", "per_batch"}


def test_hash_table_inserts_keep_the_table_dict():
    """The host-mirror push inserts ids through _ht_insert_chunks: the
    ledger keeps the same table dict and matrix (ht_write updates them in
    place), so the window graphs stay valid."""
    led = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    table = led.state["xfer_ht"]
    packed = table["packed"]
    sig = state_signature(led.state)
    led._ht_insert_chunks("xfer_ht", [(123, 4), (456, 5)])
    assert led.state["xfer_ht"] is table
    assert led.state["xfer_ht"]["packed"] is packed
    assert state_signature(led.state) == sig


def test_a_rebuilt_state_drops_the_window_graphs():
    """from_host (and a state assigned from outside) moves the state's
    storage: the next window drops every graph and starts eagerly."""
    trio = Trio()
    led = trio.port
    w = _pipe_windows(np.random.default_rng(5), 3)
    led.create_transfers_window(_arrays(w[0][0]), w[0][1])
    assert led.windows.drops == 0
    led.from_host(led.to_host())
    led.create_transfers_window(_arrays(w[1][0]), w[1][1])
    assert led.windows.drops == 1
    led.state = state_from_numpy(state_to_numpy(led.state), "cpu")
    led.create_transfers_window(_arrays(w[2][0]), w[2][1])
    assert led.windows.drops == 2
    key = ("chain", 3, PAD)
    assert led.windows.eager == {key: 3}
    assert led.windows.captures == {} and led.windows.replays == {}


def test_window_packers_match_the_jax_package():
    """stack_superbatch / stack_chain_window equal the JAX package's, and
    fill_window writes their lanes (the window routes' one-pass packer)."""
    batches, tss = _window("refs")
    evs = _arrays(batches)
    for ours, theirs in ((TL.stack_superbatch, JL.stack_superbatch),
                         (TL.stack_chain_window, JL.stack_chain_window)):
        got, want = ours(evs, tss, PAD), theirs(evs, tss, PAD)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], k)
                assert g[k].dtype == w[k].dtype, k
        lanes = np.empty((len(TL._LANES), len(evs), PAD), dtype=np.int64)
        TL.fill_window(lanes, evs, tss, PAD)
        lanes = torch.from_numpy(lanes)
        if ours is TL.stack_superbatch:
            lanes = lanes.reshape(len(TL._LANES), -1)
        ev, seg = TL.unpack_window(lanes)
        for k, v in {**got[0], **got[1]}.items():
            assert torch.equal(ev.get(k, seg.get(k)), carrier(v, "cpu")), k
    assert TL._evs_pend_refs(evs) == JL._evs_pend_refs(evs) is True
    assert TL._evs_pend_refs(_arrays(_window("clean")[0])) is False


@pytest.mark.parametrize("case", ["none", "exact", "lo_only", "hi_only",
                                  "zero_pids", "same_prepare"])
def test_pend_ref_pre_route_matches_the_jax_package(case):
    """The window pre-route's in-window reference test equals the JAX
    package's on keys that agree in one half only, and on exact
    matches across and inside a prepare."""
    rng = np.random.default_rng(8)
    evs = [transfers_to_arrays(_uniform(rng, 1000 + 100 * b, 50))
           for b in range(3)]
    for e in evs:
        e["id_hi"][:] = rng.integers(1, 1 << 40, 50, dtype=np.uint64)
    tgt, src = evs[2], evs[0]
    if case == "exact":
        tgt["pid_hi"][4], tgt["pid_lo"][4] = src["id_hi"][9], src["id_lo"][9]
    elif case == "lo_only":
        tgt["pid_hi"][4], tgt["pid_lo"][4] = np.uint64(7), src["id_lo"][9]
    elif case == "hi_only":
        tgt["pid_hi"][4], tgt["pid_lo"][4] = src["id_hi"][9], np.uint64(7)
    elif case == "same_prepare":
        tgt["pid_hi"][4], tgt["pid_lo"][4] = tgt["id_hi"][9], tgt["id_lo"][9]
    elif case == "none":
        tgt["pid_lo"][4] = np.uint64(3)
    want = JL._evs_pend_refs(evs)
    assert TL._evs_pend_refs(evs) is want
    assert want is (case in ("exact", "same_prepare"))


def test_window_graph_cache_is_bounded():
    """A ledger keeps at most MAX_GRAPHS captured graphs: the least
    recently replayed one goes (and its key starts over eagerly) before
    another is captured. The bookkeeping alone (no graph on the CPU)."""
    from tigerbeetle_tpu_torch.ops import window_graph as WG

    wg = WG.WindowGraphs(torch.device("cpu"))
    keys = [("chain", w, PAD) for w in range(2, 2 + WG.MAX_GRAPHS)]
    for k in keys:
        wg._seen.add(k)
        wg._graphs[k] = (None, None)
    # Replaying the oldest key makes the second one the least recent.
    wg._graphs[keys[0]] = wg._graphs.pop(keys[0])
    wg._make_room()
    assert len(wg._graphs) == WG.MAX_GRAPHS - 1 and wg.evictions == 1
    assert keys[1] not in wg._graphs and keys[1] not in wg._seen
    assert keys[0] in wg._graphs
