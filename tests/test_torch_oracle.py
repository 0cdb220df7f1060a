"""The port's copy of the oracle against the JAX package's
StateMachineOracle.

The same fuzzed batches, made from a numpy seed, go through both: every
flag (linked chains, two-phase, balancing, closing, imported batches),
repeated and failing ids, then the expiry pulse. Results must be equal
event for event and the whole state equal after every step. Pure Python
on both sides: no JAX program is compiled here.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke as CS
import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.oracle import StateMachineOracle as JaxOracle
from tigerbeetle_tpu.types import Account, Transfer
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.oracle import StateMachineOracle

N_ACCOUNTS = 60


def _objs(objs, cls):
    return [cls(**dataclasses.asdict(o)) for o in objs]


def _res(results):
    return [(r.timestamp, int(r.status)) for r in results]


def _tuple(o):
    return None if o is None else dataclasses.astuple(o)


def state_of(sm) -> dict:
    """Every container and scalar of an oracle state, as plain values
    (the two packages' dataclasses compare as tuples)."""
    return dict(
        accounts={k: _tuple(v) for k, v in sm.accounts.items()},
        transfers={k: _tuple(v) for k, v in sm.transfers.items()},
        orphaned=set(sm.orphaned),
        pending_status={k: int(v) for k, v in sm.pending_status.items()},
        expiry=dict(sm.expiry),
        account_by_timestamp=dict(sm.account_by_timestamp),
        transfer_by_timestamp=dict(sm.transfer_by_timestamp),
        account_events=[
            (r.timestamp, _tuple(r.dr_account), _tuple(r.cr_account),
             r.transfer_flags, int(r.transfer_pending_status),
             _tuple(r.transfer_pending), r.amount_requested, r.amount)
            for r in sm.account_events],
        scalars=(sm.accounts_key_max, sm.transfers_key_max,
                 sm.commit_timestamp, sm.pulse_next_timestamp,
                 sm.events_base),
    )


def fuzz_steps(seed: int, n: int = 120):
    """(op, events, timestamp) steps on the port's types: accounts,
    committed pendings, mixed transfer batches, an imported transfer
    batch, an imported and a mixed accounts batch, then the expiry
    pulse."""
    rng = np.random.default_rng(seed)
    steps = []
    ts = 10**12
    accounts = CS.seq_mixed_accounts(TT.Account, TT.AccountFlags, rng,
                                     N_ACCOUNTS, 1)
    for a in accounts:
        a.flags &= ~int(TT.AccountFlags.linked)
    steps.append(("create_accounts", accounts, ts))
    pend = [TT.Transfer(id=10**6 + j, debit_account_id=1 + j % N_ACCOUNTS,
                        credit_account_id=1 + (j + 5) % N_ACCOUNTS,
                        amount=50 + j, ledger=1, code=1,
                        flags=TT.TransferFlags.pending,
                        timeout=(1 if j % 3 == 0 else 0))
            for j in range(40)]
    ts += 1000
    steps.append(("create_transfers", pend, ts))
    pend_ids = [t.id for t in pend]
    for b in range(3):
        ts += 10**4
        steps.append(("create_transfers", CS.seq_mixed_transfers(
            TT.Transfer, TT.TransferFlags, rng, n, 2 * 10**6 + b * 10**4,
            N_ACCOUNTS, pend_ids), ts))
    ts += 10**4
    steps.append(("create_transfers", CS.seq_mixed_transfers(
        TT.Transfer, TT.TransferFlags, rng, n, 3 * 10**6, N_ACCOUNTS,
        pend_ids, imported_after=ts - 5000), ts))
    ts += 10**4
    steps.append(("create_accounts", CS.seq_mixed_accounts(
        TT.Account, TT.AccountFlags, rng, n, 10**5,
        imported_after=ts - 5000), ts))
    ts += 10**4
    steps.append(("create_accounts", CS.seq_mixed_accounts(
        TT.Account, TT.AccountFlags, rng, n, 2 * 10**5), ts))
    steps.append(("expire_pending_transfers", None, ts + 5 * 10**9))
    return steps


def run_both(port, ref, step):
    """One step on the port's oracle and the JAX package's; returns both
    results (statuses and timestamps, or the expired count)."""
    op, events, ts = step
    if events is None:
        return getattr(port, op)(ts), getattr(ref, op)(ts)
    cls = Account if op == "create_accounts" else Transfer
    return (_res(getattr(port, op)(events, ts)),
            _res(getattr(ref, op)(_objs(events, cls), ts)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_oracle_copy_matches_the_jax_oracle_on_fuzzed_batches(seed):
    port, ref = StateMachineOracle(), JaxOracle()
    statuses = set()
    for step in fuzz_steps(seed):
        got, want = run_both(port, ref, step)
        assert got == want, step[0]
        assert state_of(port) == state_of(ref), step[0]
        if isinstance(got, list):
            statuses.update(s for _, s in got)
    assert len(statuses) >= 25  # the fuzz reaches most result codes
    assert port.pulse_needed(0) == ref.pulse_needed(0)


def test_chain_rollback_and_pulse_match_the_jax_oracle():
    """A broken chain that posted, voided and closed before it broke,
    then expiry: the scope restore and pulse_next (not restored on
    rollback) agree."""
    F = TT.TransferFlags
    port, ref = StateMachineOracle(), JaxOracle()
    accounts = [TT.Account(id=i, ledger=1, code=1) for i in (1, 2, 3)]
    pend = [TT.Transfer(id=10 + i, debit_account_id=1, credit_account_id=2,
                        amount=5, ledger=1, code=1, flags=F.pending,
                        timeout=1 + i) for i in range(3)]
    chain = [
        TT.Transfer(id=20, pending_id=10, flags=F.post_pending_transfer
                    | F.linked),
        TT.Transfer(id=21, pending_id=11, flags=F.void_pending_transfer
                    | F.linked),
        TT.Transfer(id=22, debit_account_id=1, credit_account_id=3,
                    amount=1, ledger=1, code=1, timeout=1,
                    flags=F.pending | F.closing_debit | F.linked),
        TT.Transfer(id=23, debit_account_id=1, credit_account_id=99,
                    amount=1, ledger=1, code=1),
    ]
    steps = [("create_accounts", accounts, 100),
             ("create_transfers", pend, 200),
             ("create_transfers", chain, 300),
             ("expire_pending_transfers", None, 10**10)]
    for step in steps:
        got, want = run_both(port, ref, step)
        assert got == want
        assert state_of(port) == state_of(ref)
    assert port.pulse_next_timestamp == ref.pulse_next_timestamp
