"""The port's vortex: chaos over real processes + real TCP + fault proxy.

reference: src/vortex.zig — the non-deterministic counterpart of VOPR.
The JAX package's `tests/test_vortex.py` on the port's supervisor, whose
replicas are `python -m tigerbeetle_tpu_torch` processes on the CPU
(`platform="cpu"`; the oracle engine, as the JAX package's). Bounded for
CI: one short storm, then heal, audit, shutdown, verify data files.
"""

import time

import pytest

from tigerbeetle_tpu_torch.main import _parse_addresses
from tigerbeetle_tpu_torch.testing.vortex import VortexSupervisor
from tigerbeetle_tpu_torch.types import Account, Transfer
from tigerbeetle_tpu_torch.vsr.client import Client


@pytest.mark.integration
def test_vortex_storm(tmp_path):
    supervisor = VortexSupervisor(str(tmp_path), replica_count=3, seed=7,
                                  platform="cpu")
    committed = []
    try:
        client = Client(cluster=supervisor.cluster, client_id=9,
                        replica_addresses=_parse_addresses(
                            supervisor.addresses))
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            try:
                client.create_accounts([Account(id=1, ledger=1, code=1),
                                        Account(id=2, ledger=1, code=1)])
                break
            except TimeoutError:
                continue
        else:
            raise AssertionError("cluster never became available")

        tid = 100
        for step in range(12):
            fault = supervisor.random_fault(max_down=1)
            amount = step + 1
            try:
                results = client.create_transfers([Transfer(
                    id=tid, debit_account_id=1, credit_account_id=2,
                    amount=amount, ledger=1, code=1)])
                if results[0].status.name in ("created", "exists"):
                    committed.append((tid, amount))
            except TimeoutError:
                # Unknown outcome: the transfer may or may not have
                # committed. Resolve it after healing.
                committed.append((tid, None))
            tid += 1
            if step == 5:
                supervisor.heal_all()  # mid-run heal keeps liveness honest
        supervisor.heal_all()

        # Audit: every known-committed transfer present; unknowns resolved.
        # Unknown-outcome prepares may still commit DURING the audit (a
        # healing view change adopts them), so transfers and accounts are
        # re-read until two consecutive observations agree — a consistent
        # snapshot of the settled cluster.
        deadline = time.monotonic() + 120
        snapshot = prev = None
        while time.monotonic() < deadline:
            try:
                transfers = {t.id: t for t in client.lookup_transfers(
                    [t for t, _ in committed])}
                accounts = {a.id: a for a in client.lookup_accounts([1, 2])}
            except TimeoutError:
                continue
            obs = (sorted(transfers), accounts[1].debits_posted,
                   accounts[2].credits_posted)
            if obs == prev:
                snapshot = (transfers, accounts)
                break
            prev = obs
        assert snapshot is not None, "cluster did not settle"
        transfers, accounts = snapshot
        total = 0
        for tid_, amount in committed:
            if amount is not None:
                assert tid_ in transfers, f"committed transfer {tid_} lost"
                total += transfers[tid_].amount
            elif tid_ in transfers:
                total += transfers[tid_].amount
        assert accounts[1].debits_posted == total
        assert accounts[2].credits_posted == total
        client.close()
    finally:
        supervisor.shutdown()
    supervisor.verify_data_files()


@pytest.mark.integration
def test_vortex_rebuild_from_cluster(tmp_path):
    """Destroy one replica's data file under live
    client traffic; a crash injected mid-rebuild restarts the rebuild
    cleanly; `recover --from-cluster` rebuilds the file; the rebuilt
    replica rejoins and its state-epoch forest digest is bit-identical
    to a healthy peer's at the same checkpoint, with zero committed-op
    divergence."""
    supervisor = VortexSupervisor(str(tmp_path), replica_count=3, seed=23,
                                  platform="cpu")
    committed = []
    victim = 2
    try:
        client = Client(cluster=supervisor.cluster, client_id=11,
                        replica_addresses=_parse_addresses(
                            supervisor.addresses))
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            try:
                client.create_accounts([Account(id=1, ledger=1, code=1),
                                        Account(id=2, ledger=1, code=1)])
                break
            except TimeoutError:
                continue
        else:
            raise AssertionError("cluster never became available")

        def pump(tid_lo, tid_hi):
            for tid in range(tid_lo, tid_hi):
                try:
                    res = client.create_transfers([Transfer(
                        id=tid, debit_account_id=1, credit_account_id=2,
                        amount=1, ledger=1, code=1)])
                    if res[0].status.name in ("created", "exists"):
                        committed.append((tid, 1))
                except TimeoutError:
                    committed.append((tid, None))  # unknown outcome

        # Drive past the 32-slot WAL window so the rebuild MUST take the
        # state-sync path (peers cannot serve op 1 from their WAL).
        pump(100, 148)
        supervisor.destroy_data_file(victim)
        pump(148, 160)  # live client load while the data file is gone
        # Crash injection: the first rebuild attempt is SIGKILLed. If it
        # was mid-install, the superblock's sync_op record marks the file
        # rebuild-only; either way the re-run must complete cleanly.
        supervisor.run_rebuild(victim, crash_after_s=1.5)
        assert supervisor.run_rebuild(victim) == 0
        supervisor.start_replica(victim)
        pump(160, 172)  # the rebuilt replica follows live traffic

        # Settle audit (zero committed-op divergence): reread until two
        # consecutive observations agree, then check every known-commit.
        deadline = time.monotonic() + 120
        snapshot = prev = None
        while time.monotonic() < deadline:
            try:
                transfers = {t.id: t for t in client.lookup_transfers(
                    [t for t, _ in committed])}
                accounts = {a.id: a for a in client.lookup_accounts([1, 2])}
            except TimeoutError:
                continue
            obs = (sorted(transfers), accounts[1].debits_posted)
            if obs == prev:
                snapshot = (transfers, accounts)
                break
            prev = obs
        assert snapshot is not None, "cluster did not settle"
        transfers, accounts = snapshot
        total = 0
        for tid, amount in committed:
            if amount is not None:
                assert tid in transfers, f"committed transfer {tid} lost"
                total += transfers[tid].amount
            elif tid in transfers:
                total += transfers[tid].amount
        assert accounts[1].debits_posted == total
        assert accounts[2].credits_posted == total
        # Give idle heartbeats a moment to level every replica's commit
        # so all three land on the same checkpoint at shutdown.
        time.sleep(2.0)
        client.close()
    finally:
        supervisor.shutdown()
    supervisor.verify_data_files()
    digests = {i: supervisor.forest_digest(i) for i in range(3)}
    ck_v, digest_v = digests[victim]
    peers_same = [i for i in (0, 1) if digests[i][0] == ck_v]
    assert peers_same, f"no healthy peer at the rebuilt checkpoint: {digests}"
    for i in peers_same:
        assert digests[i][1] == digest_v, \
            f"forest digest divergence r{i} vs rebuilt r{victim}: {digests}"
