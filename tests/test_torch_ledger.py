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
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    port.create_accounts([TT.Account(id=i, ledger=1, code=1)
                          for i in range(1, 5)], TS0)
    port.create_transfers([TT.Transfer(id=9, debit_account_id=1,
                                       credit_account_id=2, amount=3,
                                       ledger=1, code=1)], TS0 + 10)
    before = device_state_digest(port.state)
    dup = [TT.Transfer(id=10, debit_account_id=1, credit_account_id=2,
                       amount=3, ledger=1, code=1)] * 2
    # The plain tier escalates the collision; the fixpoint tier finds a
    # real duplicate id and falls back, so the ledger raises.
    with pytest.raises(TL.DeviceTierFallback) as err:
        port.create_transfers(dup, TS0 + 20)
    assert not err.value.limit_only and err.value.fb_causes["e2_collision"]
    assert port.escalations == 1 and port.fixpoint_batches == 0
    bal = [TT.Transfer(id=11, debit_account_id=1, credit_account_id=2,
                       amount=3, ledger=1, code=1,
                       flags=TT.TransferFlags.balancing_debit)]
    with pytest.raises(TL.DeviceTierFallback) as err:
        port.create_transfers(bal, TS0 + 30)
    assert not err.value.limit_only
    assert err.value.fb_causes["e1_hard_flags"]
    with pytest.raises(TL.DeviceTierFallback):
        port.create_accounts([TT.Account(id=7, ledger=1, code=1)] * 2,
                             TS0 + 40)
    assert device_state_digest(port.state) == before
    assert port.fallbacks == 3 and port.fast_batches == 2


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
    """A 40-wave cascade outruns the 32-round tier too: the port raises
    DeviceTierFallback and leaves its state as it was, after the same
    ladder (and the same counters) as the JAX ledger, which then takes
    its exact host path."""
    port = DeviceLedger(a_cap=A_CAP, t_cap=T_CAP, device="cpu")
    jax_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    sm = StateMachineOracle()
    _run_all(_ladder_setup(44), port, jax_led, sm)
    before = device_state_digest(port.state)
    events = _cascade(40, 2, 5000)
    with pytest.raises(TL.DeviceTierFallback) as err:
        port.create_transfers(_port_objs(events, TT.Transfer), TS0 + 9000)
    assert err.value.fb_causes["e3_limit"] and not err.value.limit_only
    assert device_state_digest(port.state) == before
    assert _res(jax_led.create_transfers(events, TS0 + 9000)) == \
        _res(sm.create_transfers(events, TS0 + 9000))
    assert _counters(port) == _counters(jax_led) == dict(
        fast=2, fixpoint=0, deep=1, escalations=2, fallbacks=1,
        fixpoint_first=False, deep_first=TL.DeviceLedger.DEEP_PROBE_INTERVAL)
