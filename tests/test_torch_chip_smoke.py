"""chip_smoke.py's config-4 phase, rehearsed on the CPU.

The card run holds its config-4 workloads to constants and predictions
written into the script: the JAX package's created counts and ladder
counters for six 8,190-event pairs, the statuses of its in-batch
two-phase batch, one deep escalation for the 12-wave cascade, and the
kernel launches each tier run makes. Here the port's CPU ledger runs the
same workloads: its results must be the oracle's, and the plain twins'
calls must number what the script predicts for the kernels' launches.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as CS
import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.oracle import StateMachineOracle
from tigerbeetle_tpu.ops.state_epoch import oracle_state_digest
from tigerbeetle_tpu.types import Account, Transfer
from tigerbeetle_tpu_torch import DeviceLedger
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.ops import fast_kernels, hash_table, ledger
from tigerbeetle_tpu_torch.ops.state_epoch import device_state_digest

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

A_CAP = 1 << 12


@pytest.fixture(autouse=True)
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture
def calls(monkeypatch):
    """Counts the plain twins' calls where the path would launch the
    kernels, one a call of a wrapper (a multi-segment call is one
    launch): {"probe": n, "gather": n}."""
    n = {"probe": 0, "gather": 0}

    def counted(fn, key):
        def call(*args, **kw):
            n[key] += 1
            return fn(*args, **kw)
        return call

    wrappers = {"ht_lookup_fused": "probe", "ht_lookup_fused_multi": "probe",
                "row_gather": "gather", "row_gather_multi": "gather"}
    for mod in (fast_kernels, hash_table, ledger):
        for name, key in wrappers.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name,
                                    counted(getattr(mod, name), key))
    return n


def _oracle_objs(objs, cls):
    return [cls(**dataclasses.asdict(o)) for o in objs]


def _res(results):
    return [(r.timestamp, r.status.name) for r in results]


def _predicted(kind, runs=1):
    return {"probe": CS.PROBES_PER_RUN[kind] * runs,
            "gather": CS.GATHERS_PER_RUN[kind] * runs}


def test_config4_pairs_give_the_jax_packages_figures(calls):
    """Six pairs at 8,190 events: the created counts and the ladder
    counters chip_smoke.py holds the card to, and the launches its tier
    runs predict."""
    led = DeviceLedger(a_cap=A_CAP, t_cap=1 << 17, device="cpu")
    led.create_accounts(CS.config4_accounts(TT.Account, TT.AccountFlags),
                        CS.C4_ACCOUNTS)
    assert calls == _predicted("accounts")
    rng = np.random.default_rng(4)
    ts, next_id = 10**12, 10**7
    created = int(TT.CreateTransferStatus.created)
    got = []
    for _ in range(CS.C4_CHECKED_PAIRS):
        pend, rev, next_id = CS.config4_pair(rng, next_id, TT.TransferFlags)
        for ev, at in ((pend, ts + CS.BATCH + 10),
                       (rev, ts + 2 * (CS.BATCH + 10))):
            before = dict(calls)
            (st, _), (plain, fix) = CS.run_tiers(
                led, lambda: led.create_transfers_soa(ev, at))
            want = {k: before[k] + _predicted("plain", plain)[k]
                    + _predicted("fixpoint", fix)[k] for k in calls}
            assert calls == want
            got.append(int((st == created).sum()))
        ts += 2 * (CS.BATCH + 10)
    assert tuple(got[0::2]) == tuple(got[1::2]) == CS.C4_JAX_CREATED
    assert CS.ladder_counters(led) == CS.C4_JAX_COUNTERS


def test_in_batch_two_phase_batch_matches_the_oracle(calls):
    led = DeviceLedger(a_cap=A_CAP, t_cap=1 << 12, device="cpu")
    sm = StateMachineOracle()
    accounts = CS.config4_accounts(TT.Account, TT.AccountFlags)
    led.create_accounts(accounts, 1000)
    sm.create_accounts(_oracle_objs(accounts, Account), 1000)
    events, expect = CS.in_batch_two_phase(TT.Transfer, TT.TransferFlags)
    before = dict(calls)
    got, (plain, fix) = CS.run_tiers(
        led, lambda: led.create_transfers(events, 5000))
    want = sm.create_transfers(_oracle_objs(events, Transfer), 5000)
    assert [r.status.name for r in want] == expect
    assert _res(got) == _res(want)
    assert device_state_digest(led.state) == oracle_state_digest(sm, A_CAP)
    # The in-batch references escalate the plain tier's collision check.
    assert (plain, fix) == (1, 1) and led.escalations == 1
    assert {k: calls[k] - before[k] for k in calls} == {
        k: _predicted("plain")[k] + _predicted("fixpoint")[k] for k in calls}


def test_cascade_escalates_once_to_the_deep_tier(calls):
    led = DeviceLedger(a_cap=1 << 10, t_cap=1 << 12, device="cpu")
    sm = StateMachineOracle()
    accounts, funds, cascade = CS.cascade_steps(
        TT.Account, TT.Transfer, TT.AccountFlags, TT.TransferFlags)
    led.create_accounts(accounts, 10**13)
    sm.create_accounts(_oracle_objs(accounts, Account), 10**13)
    for events, ts in ((funds, 10**13 + 1000), (cascade, 10**13 + 5000)):
        before = dict(calls)
        got, (plain, fix) = CS.run_tiers(
            led, lambda: led.create_transfers(events, ts))
        assert _res(got) == _res(sm.create_transfers(
            _oracle_objs(events, Transfer), ts))
        assert {k: calls[k] - before[k] for k in calls} == {
            k: _predicted("plain", plain)[k] + _predicted("fixpoint", fix)[k]
            for k in calls}
    assert (plain, fix) == (1, 2)
    assert CS.ladder_counters(led)[2:] == (1, 2, 0)
    assert device_state_digest(led.state) == oracle_state_digest(sm, 1 << 10)
