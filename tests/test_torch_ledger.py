"""Port parity, end to end: the port's DeviceLedger on the CPU against the
JAX package's DeviceLedger and the StateMachineOracle.

The same batches (made from a numpy seed) go through all three; results
must match the oracle's exactly, the port's state digest must equal
`oracle_state_digest`, lookups must agree, and a state carried over from
a JAX ledger with `state_from_numpy` must continue identically.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.oracle import StateMachineOracle
from tigerbeetle_tpu.ops import ledger as JL
from tigerbeetle_tpu.ops.state_epoch import device_state_digest as jax_digest
from tigerbeetle_tpu.ops.state_epoch import oracle_state_digest
from tigerbeetle_tpu.types import Account, Transfer
from tigerbeetle_tpu.types import AccountFlags as AF
from tigerbeetle_tpu.types import TransferFlags as TF
from tigerbeetle_tpu_torch import DeviceLedger, state_from_numpy
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.ops import hash_table as THT
from tigerbeetle_tpu_torch.ops import ledger as TL
from tigerbeetle_tpu_torch.ops.state_epoch import device_state_digest

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

A_CAP = 1 << 10
T_CAP = 1 << 12
TS0 = 10_000_000_000_000


@pytest.fixture(autouse=True)
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _port_objs(objs, cls):
    return [cls(**dataclasses.asdict(o)) for o in objs]


def _res(results):
    return [(r.timestamp, r.status.name) for r in results]


def _batches(seed=0):
    """(kind, events, timestamp) steps: accounts in two batches, uniform
    transfers, pendings, then a mixed batch (post/void of committed
    pendings, a chain with a failing member, failing lanes)."""
    rng = np.random.default_rng(seed)
    ts = TS0
    steps = []
    accts = [Account(id=i, ledger=1, code=1,
                     user_data_64=int(rng.integers(1 << 40)))
             for i in range(1, 121)]
    accts[5].flags = AF.closed
    for lo in (0, 70):
        chunk = accts[lo:lo + 70]
        ts += len(chunk) + 5
        steps.append(("create_accounts", chunk, ts))
    for b in range(2):
        n = 300
        dr = rng.integers(1, 121, n)
        cr = rng.integers(1, 121, n)
        cr = np.where(cr == dr, cr % 120 + 1, cr)
        evs = [Transfer(id=10_000 + 1000 * b + i, debit_account_id=int(dr[i]),
                        credit_account_id=int(cr[i]),
                        amount=int(rng.integers(1, 10**9)), ledger=1,
                        code=1)
               for i in range(n)]
        evs[7].debit_account_id = 6        # closed account
        evs[9].credit_account_id = 5000    # not found: orphaned id
        ts += n + 11
        steps.append(("create_transfers", evs, ts))
    P, POST, VOID, L = (TF.pending, TF.post_pending_transfer,
                        TF.void_pending_transfer, TF.linked)
    pend = [Transfer(id=20_000 + i, debit_account_id=10 + i,
                     credit_account_id=60 + i, amount=500 + i, ledger=1,
                     code=2, flags=P, timeout=(0 if i % 2 else 30))
            for i in range(20)]
    ts += 40
    steps.append(("create_transfers", pend, ts))
    mixed = [
        Transfer(id=30_000, pending_id=20_000, flags=POST, amount=(1 << 128) - 1),
        Transfer(id=30_001, pending_id=20_001, flags=VOID),
        Transfer(id=30_002, pending_id=20_002, flags=POST, amount=100),
        Transfer(id=30_003, pending_id=20_003, flags=POST, amount=10**6),
        Transfer(id=30_004, pending_id=29_999, flags=POST),
        Transfer(id=30_005, debit_account_id=1, credit_account_id=2,
                 amount=5, ledger=1, code=1, flags=L),
        Transfer(id=30_006, debit_account_id=2, credit_account_id=9999,
                 amount=5, ledger=1, code=1, flags=L),
        Transfer(id=30_007, debit_account_id=3, credit_account_id=4,
                 amount=5, ledger=1, code=1),
        Transfer(id=10_009, debit_account_id=1, credit_account_id=2,
                 amount=5, ledger=1, code=1),       # id_already_failed
        Transfer(id=10_001, debit_account_id=1, credit_account_id=2,
                 amount=5, ledger=1, code=1),       # exists, different
        Transfer(id=30_008, debit_account_id=3, credit_account_id=4,
                 amount=5, ledger=2, code=1),
        Transfer(id=30_009, debit_account_id=7, credit_account_id=8,
                 amount=77, ledger=1, code=1, flags=P, timeout=5),
    ]
    ts += 25
    steps.append(("create_transfers", mixed, ts))
    return steps


def _run_all(steps, port, jax_led, sm):
    for fn, evs, ts in steps:
        want = getattr(sm, fn)(evs, ts)
        cls = TT.Account if fn == "create_accounts" else TT.Transfer
        got = getattr(port, fn)(_port_objs(evs, cls), ts)
        assert _res(got) == _res(want), fn
        if jax_led is not None:
            assert _res(getattr(jax_led, fn)(evs, ts)) == _res(want), fn
        assert device_state_digest(port.state) == oracle_state_digest(
            sm, A_CAP)


def test_ledger_matches_oracle_jax_ledger_and_digest():
    steps = _batches()
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    _run_all(steps, port, jax_led, sm)
    assert device_state_digest(port.state) == jax_digest(jax_led.state)
    assert port.fallbacks == 0 and port.fast_batches == len(steps)

    # Lookups: port vs JAX ledger vs oracle (missing and orphaned ids
    # are absent).
    acct_ids = [1, 6, 60, 119, 5000, 0]
    want = [dataclasses.astuple(a) for a in sm.lookup_accounts(acct_ids)]
    assert [dataclasses.astuple(a)
            for a in port.lookup_accounts(acct_ids)] == want
    assert [dataclasses.astuple(a)
            for a in jax_led.lookup_accounts(acct_ids)] == want
    xfer_ids = [10_000, 10_009, 20_000, 20_005, 30_000, 30_001, 30_009,
                99_999]
    want = [dataclasses.astuple(t) for t in sm.lookup_transfers(xfer_ids)]
    assert [dataclasses.astuple(t)
            for t in port.lookup_transfers(xfer_ids)] == want
    assert [dataclasses.astuple(t)
            for t in jax_led.lookup_transfers(xfer_ids)] == want


def test_state_carried_over_from_a_jax_ledger_continues_identically():
    steps = _batches(seed=1)
    head, tail = steps[:4], steps[4:]
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    for fn, evs, ts in head:
        assert _res(getattr(jax_led, fn)(evs, ts)) == \
            _res(getattr(sm, fn)(evs, ts))
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    port.state = state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax.device_get(jax_led.state)),
        "cpu")
    assert device_state_digest(port.state) == jax_digest(jax_led.state)
    _run_all(tail, port, jax_led, sm)
    assert device_state_digest(port.state) == jax_digest(jax_led.state)


def test_soa_entry_returns_status_and_timestamp_arrays():
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    sm = StateMachineOracle()
    accts = [Account(id=i, ledger=1, code=1) for i in (1, 2, 3)]
    port.create_accounts(_port_objs(accts, TT.Account), TS0)
    sm.create_accounts(accts, TS0)
    xfers = [Transfer(id=50 + i, debit_account_id=1 + i % 3,
                      credit_account_id=1 + (i + 1) % 3, amount=9, ledger=1,
                      code=1) for i in range(6)]
    xfers[2].ledger = 7
    from tigerbeetle_tpu.ops.batch import transfers_to_arrays
    st, ts = port.create_transfers_soa(transfers_to_arrays(xfers), TS0 + 50)
    want = sm.create_transfers(xfers, TS0 + 50)
    assert st.dtype == np.uint32 and ts.dtype == np.uint64
    assert list(zip(ts.tolist(), st.tolist())) == [
        (r.timestamp, int(r.status)) for r in want]


def test_fallback_raises_and_leaves_state_unchanged():
    """The batches no device tier can run take the exact path (they used
    to raise): a real in-batch duplicate id (the plain tier escalates the
    collision; the fixpoint tier finds the duplicate and falls back)
    enters the host-mirror regime, where a balancing batch and an
    accounts batch with a repeated id run too. Results equal the JAX
    ledger's and the oracle's, and so do the digest and the counters."""
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    steps = [
        ("create_accounts", [Account(id=i, ledger=1, code=1)
                             for i in range(1, 5)], TS0),
        ("create_transfers", [Transfer(id=9, debit_account_id=1,
                                       credit_account_id=2, amount=3,
                                       ledger=1, code=1)], TS0 + 10),
        ("create_transfers", [Transfer(id=10, debit_account_id=1,
                                       credit_account_id=2, amount=3,
                                       ledger=1, code=1)] * 2, TS0 + 20),
    ]
    _run_all(steps, port, jax_led, sm)
    assert _counters(port) == _counters(jax_led)
    assert port.escalations == 1 and port.fixpoint_batches == 0
    assert port.fallbacks == 1 and port.mirror is not None
    assert port.fallback_causes == jax_led.fallback_causes
    assert port.fallback_causes["e2_collision"] == 1
    more = [
        ("create_transfers", [Transfer(id=11, debit_account_id=1,
                                       credit_account_id=2, amount=3,
                                       ledger=1, code=1,
                                       flags=TF.balancing_debit)],
         TS0 + 30),
        ("create_accounts", [Account(id=7, ledger=1, code=1)] * 2, TS0 + 40),
    ]
    _run_all(more, port, jax_led, sm)
    assert device_state_digest(port.state) == jax_digest(jax_led.state)
    assert _counters(port) == _counters(jax_led)
    assert port.fallbacks == 3 and port.fast_batches == 2
    assert port.fallback_causes == jax_led.fallback_causes


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the error path is for "
                    "hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.init_state(A_CAP, T_CAP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        THT.ht_init(64)


def test_host_packers_match_jax():
    sm = StateMachineOracle()
    steps = _batches(seed=2)
    for fn, evs, ts in steps:
        getattr(sm, fn)(evs, ts)
    accounts = sorted(sm.accounts.values(), key=lambda a: a.timestamp)
    for g, w in zip(TL._pack_account_rows(accounts),
                    JL._pack_account_rows(accounts)):
        np.testing.assert_array_equal(g, w)
    acct_row = {a.id: r for r, a in enumerate(accounts)}
    xfers = [sm.transfers[t] for t in sm.transfer_by_timestamp.values()]
    args = (lambda o: int(sm.pending_status.get(o.timestamp, 0)),
            lambda aid, dump: acct_row.get(aid, dump), A_CAP)
    np.testing.assert_array_equal(TL._pack_transfer_rows(xfers, *args),
                                  JL._pack_transfer_rows(xfers, *args))
    xfer_row = {t.id: r for r, t in enumerate(xfers)}
    recs = list(sm.account_events)
    assert recs
    np.testing.assert_array_equal(
        TL._pack_event_rows(recs, acct_row, xfer_row, A_CAP)["u64"],
        JL._pack_event_rows(recs, acct_row, xfer_row, A_CAP)["u64"])


def test_chip_smoke_mixed_workload_matches_the_oracle():
    """chip_smoke.py holds the card's mixed batch to hard-coded statuses;
    they must be the oracle's, and the port's CPU ledger must give them."""
    import chip_smoke

    sm = StateMachineOracle()
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    accts = [Account(id=i, ledger=1, code=1) for i in range(1, 201)]
    sm.create_accounts(accts, TS0)
    port.create_accounts(_port_objs(accts, TT.Account), TS0)
    # The workload only touches accounts below 200 and the missing ids
    # it names (N_ACCOUNTS + k), which are absent here as on the card.
    ts = TS0
    for events, expect in chip_smoke.mixed_batches(TT.Transfer,
                                                   TT.TransferFlags):
        ts += 10_000
        want = sm.create_transfers(_port_objs(events, Transfer), ts)
        assert [r.status.name for r in want] == expect
        assert _res(port.create_transfers(events, ts)) == _res(want)
    assert device_state_digest(port.state) == oracle_state_digest(sm, A_CAP)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    repo = __import__("pathlib").Path(__file__).resolve().parent.parent
    for cwd in (repo, tmp_path):
        script = repo / "chip_smoke.py"
        if cwd == tmp_path:
            script = tmp_path / "chip_smoke.py"
            script.write_text((repo / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


# ------------------------------------------------- the escalation ladder

def _counters(led):
    return dict(fast=led.fast_batches, fixpoint=led.fixpoint_batches,
                deep=led.deep_fixpoint_batches, escalations=led.escalations,
                fallbacks=led.fallbacks, fixpoint_first=led._fixpoint_first,
                deep_first=led._deep_first)


def _cascade(k_chains, first_acct, first_id):
    """k linked chains forming a k-wave limit cascade (the construction of
    tests/test_fixpoint_escalation.py): chain k debits limited account
    first_acct + k by 20 (its credit 10 plus the relief credit 10 the
    previous chain's second member would land) and credits the next one
    by 10; chain 0's credit names a missing account, so the sequential
    truth unwinds one chain a wave."""
    events = []
    for k in range(k_chains):
        acct = first_acct + k
        events.append(Transfer(id=first_id + 2 * k, debit_account_id=acct,
                               credit_account_id=1, amount=20, ledger=1,
                               code=1, flags=TF.linked))
        events.append(Transfer(id=first_id + 2 * k + 1, debit_account_id=1,
                               credit_account_id=(999_999 if k == 0
                                                  else acct + 1),
                               amount=10, ledger=1, code=1))
    return events


def _ladder_setup(n_limited):
    """Account 1 unlimited, 2..n_limited + 1 debit-limited with a credit
    of 10 each, 200..203 unlimited."""
    accts = [Account(id=1, ledger=1, code=1)]
    accts += [Account(id=i, ledger=1, code=1,
                      flags=AF.debits_must_not_exceed_credits)
              for i in range(2, n_limited + 2)]
    accts += [Account(id=i, ledger=1, code=1) for i in range(200, 204)]
    fund = [Transfer(id=100 + i, debit_account_id=1, credit_account_id=i,
                     amount=10, ledger=1, code=1)
            for i in range(2, n_limited + 2)]
    return [("create_accounts", accts, TS0),
            ("create_transfers", fund, TS0 + 1000)]


def _x(i, dr, cr, amount, **kw):
    return Transfer(id=i, debit_account_id=dr, credit_account_id=cr,
                    amount=amount, ledger=1, code=1, **kw)


def _breach(i, acct):
    """Two debits of 6 from a limited account with a headroom of 10 or
    less: the headroom proof fails."""
    return [_x(i, acct, 200, 6), _x(i + 1, acct, 201, 6)]


def _in_batch_two_phase(i):
    return [_x(i, 202, 203, 50, flags=TF.pending),
            _x(i + 1, 0, 0, (1 << 128) - 1, pending_id=i,
               flags=TF.post_pending_transfer),
            _x(i + 2, 203, 202, 5)]


def test_escalation_ladder_matches_the_jax_ledger_and_the_oracle():
    """Plain -> 8-round escalation and the fixpoint-first regime with its
    drop-back; an in-batch pending reference escalating; a 12-wave
    cascade escalating to the 32-round tier and the deep-first regime
    for DEEP_PROBE_INTERVAL batches, then the shallow re-probe. The
    counters equal the JAX ledger's after every batch."""
    steps = _ladder_setup(20)
    ts = TS0 + 2000
    plan = [
        ("breach escalates", _breach(1000, 2)),
        ("fixpoint first, breach", _breach(1010, 3)),
        ("no breach: drop back", _in_batch_two_phase(1020)),
        ("plain", [_x(1030, 200, 201, 1)]),
        ("in-batch pending escalates", _in_batch_two_phase(1040)),
        ("no breach: drop back", [_x(1050, 201, 200, 1)]),
        ("12-wave cascade", _cascade(12, 5, 2000)),
    ]
    plan += [(f"deep first {k}", _breach(3000 + 10 * k, 4))
             for k in range(TL.DeviceLedger.DEEP_PROBE_INTERVAL + 1)]
    plan += [("no breach: drop back", [_x(4000, 200, 202, 1)]),
             ("plain again", [_x(4010, 202, 200, 1)])]
    for _, evs in plan:
        ts += 1000
        steps.append(("create_transfers", evs, ts))

    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    seen = []
    for k, step in enumerate(steps):
        _run_all([step], port, jax_led, sm)
        assert _counters(port) == _counters(jax_led), (k, step[0])
        seen.append(_counters(port))
    assert device_state_digest(port.state) == jax_digest(jax_led.state)

    by_label = dict(zip(["accounts", "fund"] + [p[0] for p in plan], seen))
    assert by_label["breach escalates"] == dict(
        fast=3, fixpoint=1, deep=0, escalations=1, fallbacks=0,
        fixpoint_first=True, deep_first=0)
    assert not by_label["plain"]["fixpoint_first"]
    assert by_label["in-batch pending escalates"]["escalations"] == 2
    assert by_label["12-wave cascade"] == dict(
        fast=9, fixpoint=6, deep=1, escalations=4, fallbacks=0,
        fixpoint_first=True, deep_first=TL.DeviceLedger.DEEP_PROBE_INTERVAL)
    last_deep = f"deep first {TL.DeviceLedger.DEEP_PROBE_INTERVAL - 1}"
    assert by_label[last_deep]["deep"] == 1 + \
        TL.DeviceLedger.DEEP_PROBE_INTERVAL
    assert by_label[last_deep]["deep_first"] == 0
    reprobe = f"deep first {TL.DeviceLedger.DEEP_PROBE_INTERVAL}"
    assert by_label[reprobe]["deep"] == by_label[last_deep]["deep"]
    assert by_label[reprobe]["fixpoint"] == \
        by_label[last_deep]["fixpoint"] + 1
    assert seen[-1] == dict(fast=len(steps), fixpoint=16, deep=9,
                            escalations=4, fallbacks=0,
                            fixpoint_first=False, deep_first=0)


def test_a_cascade_beyond_the_deep_tier_raises_with_the_state_unchanged():
    """A 40-wave cascade outruns the 32-round tier too: after the same
    ladder as the JAX ledger (plain -> 8 rounds -> 32 rounds) the port
    answers it on the exact path, with the JAX ledger's results, digest
    and counters (one fallback, cause e3_limit)."""
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    _run_all(_ladder_setup(44), port, jax_led, sm)
    events = _cascade(40, 2, 5000)
    _run_all([("create_transfers", events, TS0 + 9000)], port, jax_led, sm)
    assert device_state_digest(port.state) == jax_digest(jax_led.state)
    assert _counters(port) == _counters(jax_led) == dict(
        fast=2, fixpoint=0, deep=1, escalations=2, fallbacks=1,
        fixpoint_first=False, deep_first=TL.DeviceLedger.DEEP_PROBE_INTERVAL)
    assert port.fallback_causes == jax_led.fallback_causes
    assert port.fallback_causes["e3_limit"] == 1


# ------------------------------------------------------ the exact path

def _state(led_or_sm):
    from test_torch_oracle import state_of
    return state_of(led_or_sm)


def _dup_batch(rng, first_id, n, hard):
    """n transfers over accounts 1..100 of ledger 1 (pending, linked and
    failing lanes among them); with `hard`, same-id duplicate pairs (a
    real in-batch duplicate: no device tier runs it)."""
    evs = []
    nid = first_id
    while len(evs) < n:
        r = rng.random()
        dr = int(rng.integers(1, 101))
        cr = dr % 100 + 1
        t = Transfer(id=nid, debit_account_id=dr, credit_account_id=cr,
                     amount=int(rng.integers(0, 500)), ledger=1,
                     code=int(rng.integers(0, 2)),
                     flags=(TF.pending if r < 0.2 else
                            TF.linked if r < 0.25 else 0))
        nid += 1
        evs.append(t)
        if hard and r > 0.8:
            evs.append(dataclasses.replace(t))
    evs[-1].flags &= ~TF.linked
    return evs, nid


def test_hard_regime_and_probe_recovery():
    """Two batches with real duplicate ids open the host-mirror regime;
    MIRROR_PROBE_INTERVAL batches later the probe returns the ledger to
    its device tiers and drops the mirror. Results, digest and counters
    equal the JAX ledger's (and the oracle's) after every batch; the
    state the device holds at the end equals the oracle's."""
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    rng = np.random.default_rng(32)
    steps = [("create_accounts", [Account(id=i, ledger=1, code=1)
                                  for i in range(1, 101)], TS0)]
    ts, nid = TS0, 10**6
    for b in range(TL.DeviceLedger.MIRROR_PROBE_INTERVAL + 4):
        evs, nid = _dup_batch(rng, nid, 60, hard=b < 2)
        ts += 300
        steps.append(("create_transfers", evs, ts))
    seen = []
    for step in steps:
        _run_all([step], port, jax_led, sm)
        assert _counters(port) == _counters(jax_led)
        assert port.fallback_causes == jax_led.fallback_causes
        seen.append((port.fallbacks, port.mirror is not None))
    assert device_state_digest(port.state) == jax_digest(jax_led.state)
    # In the regime from the first hard batch for MIRROR_PROBE_INTERVAL
    # batches; the probe after them runs on the device and drops it.
    interval = TL.DeviceLedger.MIRROR_PROBE_INTERVAL
    assert seen[1:3] == [(1, True), (2, True)]
    assert seen[1 + interval] == (interval, False)
    assert port.mirror is None and jax_led.mirror is None
    # The second hard batch ran on the held mirror: one device fallback.
    assert port.fallback_causes == {"e2_collision": 1}
    assert _state(port.to_host()) == _state(sm)


def test_fast_path_hard_batches_on_the_exact_path():
    """The scenarios of the JAX package's test_fast_path.py (hard batches,
    the pair-sum overflow): a balancing batch runs on the balancing tier
    in both ledgers; the overflow falls back in both. Statuses,
    timestamps, digests and counters equal the JAX ledger's and the
    oracle's after every batch."""
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    big = 1 << 127
    top = (1 << 128) - 1
    P, POST, VOID = (TF.pending, TF.post_pending_transfer,
                     TF.void_pending_transfer)
    x = _x
    plan = [
        ("create_accounts", [
            Account(id=1, ledger=1, code=1), Account(id=2, ledger=1, code=1),
            Account(id=3, ledger=1, code=1,
                    flags=AF.debits_must_not_exceed_credits),
            Account(id=4, ledger=1, code=1), Account(id=5, ledger=1, code=1),
            Account(id=6, ledger=1, code=1)]),
        ("create_transfers", [x(1, 1, 3, 10), x(2, 3, 2, 5), x(3, 3, 2, 6)]),
        ("create_transfers", [x(4, 1, 2, top, flags=TF.balancing_debit)]),
        ("create_transfers", [x(5, 1, 2, 5, flags=P),
                              x(6, 0, 0, top, pending_id=5, flags=POST)]),
        ("create_transfers", [x(7, 1, 2, 1, flags=P | TF.closing_debit)]),
        ("create_transfers", [x(8, 0, 0, 0, pending_id=7, flags=VOID)]),
        ("create_transfers", [x(11, 4, 5, big, flags=P)]),
        ("create_transfers", [x(12, 0, 0, top, pending_id=11, flags=POST)]),
        ("create_transfers", [x(13, 4, 5, big - 10, flags=P)]),
        ("create_transfers", [x(14, 4, 6, 100)]),
    ]
    ts = TS0
    for k, (fn, evs) in enumerate(plan):
        ts += len(evs) + 7
        _run_all([(fn, evs, ts)], port, jax_led, sm)
        assert device_state_digest(port.state) == jax_digest(jax_led.state)
        assert _counters(port) == _counters(jax_led)
        if k == 1:
            assert port.fixpoint_batches == jax_led.fixpoint_batches == 1
        if k == 2:
            assert port.fallbacks == 0 and port.fixpoint_batches == 2
    assert port.lookup_transfers([14]) == []
    assert _state(port.to_host()) == _state(sm)


def test_overflow_pair_sum_falls_back_in_both():
    """test_fast_path.py's pair-sum overflow alone: both ledgers fall back
    on the same batch (u128 overflow of a pair sum), with the same
    counters and causes, and report overflows_debits."""
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    big = 1 << 127
    steps = [("create_accounts", [Account(id=i, ledger=1, code=1)
                                  for i in (1, 2, 3)], TS0)]
    for k, evs in enumerate([
            [_x(1, 1, 2, big, flags=TF.pending)],
            [_x(2, 0, 0, (1 << 128) - 1, pending_id=1,
                flags=TF.post_pending_transfer)],
            [_x(3, 1, 2, big - 10, flags=TF.pending)],
            [_x(4, 1, 3, 100)]]):
        steps.append(("create_transfers", evs, TS0 + 100 * (k + 1)))
    _run_all(steps, port, jax_led, sm)
    assert _counters(port) == _counters(jax_led)
    assert port.fallbacks == 3  # the first u128 batch opens the regime
    assert port.fallback_causes == jax_led.fallback_causes
    assert port.lookup_transfers([4]) == []
    want = sm.create_transfers([_x(5, 1, 3, 100)], TS0 + 1000)
    assert want[0].status.name == "overflows_debits"


def test_duplicate_account_ids_fall_back_in_both():
    """An accounts batch that repeats an id: both ledgers' device tier
    falls back and the exact path answers (exists for the identical
    repeat, exists_with_different_* for the other), with equal counters;
    the batches after it run on the mirror in both."""
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    accts = [Account(id=i, ledger=1, code=1) for i in range(1, 6)]
    accts += [Account(id=2, ledger=1, code=1),
              Account(id=3, ledger=1, code=1, user_data_64=9)]
    steps = [("create_accounts", accts, TS0),
             ("create_transfers", [_x(1, 1, 2, 5)], TS0 + 100)]
    _run_all(steps, port, jax_led, sm)
    assert _counters(port) == _counters(jax_led)
    assert (port.fallbacks, port.fast_batches) == (2, 0)
    assert port.mirror is not None and jax_led.mirror is not None
    assert sm.accounts[3].user_data_64 == 0


def test_imported_batches_take_the_exact_path():
    """Imported transfers and accounts run on the imported tiers, as in
    the JAX ledger (no exact path: the name is the route's before the
    port had them), answering as the oracle does: past timestamps, a
    regressing one, a collision with an account's timestamp and a
    missing flag among them; the counters equal the JAX ledger's."""
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    IA, IT = AF.imported, TF.imported
    xfers = [Transfer(id=1000 + i, debit_account_id=1 + i % 4,
                      credit_account_id=2 + i % 4, amount=7, ledger=1,
                      code=1, flags=IT, timestamp=TS0 + 1000 + 3 * i)
             for i in range(12)]
    xfers[4].timestamp = TS0 - 4     # an account's timestamp
    xfers[7].timestamp = TS0 + 1001  # regresses
    accts = [Account(id=20 + i, ledger=1, code=1, flags=IA,
                     timestamp=TS0 + 5000 + i) for i in range(8)]
    accts[5].timestamp = TS0 - 100   # regresses
    accts[6].flags, accts[6].timestamp = 0, 0  # not imported
    steps = [("create_accounts", [Account(id=i, ledger=1, code=1)
                                  for i in range(1, 9)], TS0),
             ("create_transfers", xfers, TS0 + 10**6),
             ("create_accounts", accts, TS0 + 2 * 10**6)]
    _run_all(steps, port, jax_led, sm)
    assert (port.fast_batches, port.fallbacks) == (3, 0)
    assert _counters(port) == _counters(jax_led)
    assert port.fallback_causes == {}
    assert sm.transfers_key_max == TS0 + 1000 + 3 * 11
    assert _state(port.to_host()) == _state(sm)


def test_expiry_pulse():
    """Pendings with a 1 s timeout: once the pulse is due, the port
    expires what the JAX ledger and the oracle expire, through the
    mirror, and the digests stay equal."""
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    evs = [Transfer(id=10**6 + i, debit_account_id=1 + i,
                    credit_account_id=2 + i, amount=10, ledger=1, code=1,
                    flags=TF.pending, timeout=1 + i % 2) for i in range(5)]
    _run_all([("create_accounts", [Account(id=i, ledger=1, code=1)
                                   for i in range(1, 8)], TS0),
              ("create_transfers", evs, TS0 + 10)], port, jax_led, sm)
    soon, later = TS0 + 10**9 + 20, TS0 + 5 * 10**9
    for ts in (soon, later):
        assert port.pulse_needed(ts) == jax_led.pulse_needed(ts) \
            == sm.pulse_needed(ts)
        n = port.expire_pending_transfers(ts)
        assert n == jax_led.expire_pending_transfers(ts) \
            == sm.expire_pending_transfers(ts) > 0
        assert device_state_digest(port.state) == jax_digest(jax_led.state)
        assert device_state_digest(port.state) == oracle_state_digest(
            sm, A_CAP)
    assert not port.pulse_needed(later + 1)
    assert not jax_led.pulse_needed(later + 1)
    assert _counters(port) == _counters(jax_led)
    host = port.to_host()
    assert all(s.name == "expired" for s in host.pending_status.values())
    assert _state(host) == _state(sm)


def test_to_host_from_host_round_trip_keeps_the_digest():
    """to_host gives the oracle's state (the JAX ledger's to_host too);
    from_host of it rebuilds a device state with the same digest, and
    the rebuilt ledger goes on exactly like the oracle."""
    steps = _batches(seed=3)
    top64, top128 = (1 << 64) - 1, (1 << 128) - 1
    # u64 fields at and above 2^63, u128 fields above 2^64, pushed by the
    # mirror (the duplicate id opens it) and carried by to_host.
    steps.append(("create_accounts", [Account(
        id=top128 - 1, ledger=1, code=1, user_data_64=top64,
        user_data_128=top128 - 7, user_data_32=(1 << 32) - 1)],
        steps[-1][2] + 10))
    steps.append(("create_transfers", [Transfer(
        id=(1 << 100) + i, debit_account_id=top128 - 1, credit_account_id=1,
        amount=(1 << 70) + i, ledger=1, code=(1 << 16) - 1,
        user_data_64=(1 << 63) + i, user_data_128=top128 - i)
        for i in (0, 0, 1)], steps[-1][2] + 20))
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    sm = StateMachineOracle()
    _run_all(steps, port, None, sm)
    assert port.mirror is not None
    host = port.to_host()
    assert _state(host) == _state(sm)
    before = device_state_digest(port.state)
    fresh = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    fresh.from_host(host)
    assert device_state_digest(fresh.state) == before
    assert _state(fresh.to_host()) == _state(sm)
    tail = [Transfer(id=40_000 + i, debit_account_id=1 + i,
                     credit_account_id=50 + i, amount=3, ledger=1, code=1)
            for i in range(20)] + [
        Transfer(id=10_001, debit_account_id=1, credit_account_id=2,
                 amount=5, ledger=1, code=1),
        Transfer(id=10_009, debit_account_id=1, credit_account_id=2,
                 amount=5, ledger=1, code=1)]
    _run_all([("create_transfers", tail, steps[-1][2] + 100)], fresh, None,
             sm)
