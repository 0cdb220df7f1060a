"""The port's deterministic in-process cluster against the JAX package's.

Both packages' `testing/cluster.py` run the same scenarios on the same
seeds, three replicas (six for the nack case) on the oracle engine,
simulated time and network: the normal path, a view change on a primary
crash, a crash and restart, a nack truncating a lost prepare, a state
sync across two checkpoints and two packet-chaos seeds. The replies the
client got (in commit order: each carries its op and its prepare's
checksum), every live replica's final state encoding, views, ops and
commit numbers must be equal; each cluster also runs its own convergence
and storage checkers. A rebuild from the cluster of a replica whose data
file was destroyed runs the same way.
"""

import pytest

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import multi_batch as J_mb
from tigerbeetle_tpu.state_machine import StateMachine as J_StateMachine
from tigerbeetle_tpu.testing import cluster as J_cluster
from tigerbeetle_tpu.types import Operation as J_Operation
from tigerbeetle_tpu.vsr import snapshot as J_snapshot
from tigerbeetle_tpu_torch import StateMachine as P_StateMachine
from tigerbeetle_tpu_torch import constants as P_constants
from tigerbeetle_tpu_torch.testing import cluster as P_cluster
from tigerbeetle_tpu_torch.types import Account, Operation, Transfer
from tigerbeetle_tpu_torch.vsr import snapshot as P_snapshot

MS = 1_000_000

PKGS = {
    "P": dict(cluster=P_cluster, Operation=Operation, snapshot=P_snapshot,
              factory=lambda: P_StateMachine("oracle", device="cpu")),
    "J": dict(cluster=J_cluster, Operation=J_Operation, snapshot=J_snapshot,
              factory=lambda: J_StateMachine(engine="oracle")),
}


def _accounts(ids) -> bytes:
    return J_mb.encode([b"".join(Account(id=i, ledger=1, code=1).pack()
                                 for i in ids)], 128)


def _transfers(specs) -> bytes:
    return J_mb.encode([b"".join(
        Transfer(id=i, debit_account_id=dr, credit_account_id=cr,
                 amount=amt, ledger=1, code=1).pack()
        for i, dr, cr, amt in specs)], 128)


class _Run:
    """One package's cluster and client for a scenario."""

    def __init__(self, pkg: str, seed: int, replica_count: int = 3,
                 network=None):
        m = PKGS[pkg]
        self.m = m
        kw = {}
        if network is not None:
            kw["network"] = m["cluster"].NetworkOptions(**network)
        self.cluster = m["cluster"].Cluster(
            seed=seed, replica_count=replica_count,
            state_machine_factory=m["factory"], **kw)
        self.client = self.cluster.client(40 + seed)

    def drive(self, op: Operation, body: bytes, ticks: int = 4000) -> None:
        self.client.request(self.m["Operation"](int(op)), body)
        ok = self.cluster.run(ticks, until=lambda: self.client.idle)
        assert ok, self.cluster.debug_status()

    def result(self) -> dict:
        c = self.cluster
        live = [r for i, r in enumerate(c.replicas) if i not in c.crashed]
        return dict(
            replies=[m.pack() for m in self.client.replies],
            states=[self.m["snapshot"].encode(r.state_machine.state)
                    for r in live],
            replicas=[(r.replica_id, r.status, r.view, r.op, r.commit_min,
                       r.superblock.op_checkpoint) for r in live],
            now=c.time.now)


def _normal(run):
    run.drive(Operation.create_accounts, _accounts([1, 2, 3]))
    run.drive(Operation.create_transfers,
              _transfers([(10, 1, 2, 100), (11, 2, 3, 50)]))
    run.cluster.settle()


def _view_change(run):
    run.drive(Operation.create_accounts, _accounts([1, 2]))
    run.cluster.crash(run.cluster.replicas[0].primary_index())
    run.drive(Operation.create_transfers, _transfers([(10, 1, 2, 7)]), 5000)
    run.cluster.settle()


def _crash_restart(run):
    run.drive(Operation.create_accounts, _accounts([1, 2]))
    run.drive(Operation.create_transfers,
              _transfers([(100 + k, 1, 2, k + 1) for k in range(20)]))
    run.cluster.settle()
    victim = (run.cluster.replicas[0].primary_index() + 1) % 3
    run.cluster.crash(victim)
    run.drive(Operation.create_transfers, _transfers([(200, 1, 2, 5)]))
    run.cluster.restart(victim)
    run.cluster.settle()


def _nack(run):
    """A prepare reaches one backup only, whose copy is then torn; the
    primary crashes; the clean peers' nacks truncate it."""
    c = run.cluster
    run.drive(Operation.create_accounts, _accounts([1, 2]))
    c.settle()
    base_op = c.replicas[2].op
    for peer in (2, 3, 4, 5):
        c.cut_links.add(frozenset((0, peer)))
    run.client.request(run.m["Operation"](int(Operation.create_transfers)),
                       _transfers([(100, 1, 2, 7)]))
    lost = base_op + 1
    assert c.run(300, until=lambda: c.replicas[1].op >= lost)
    storage = c.storages[1]
    psm = storage.layout.message_size_max
    slot = lost % storage.layout.slot_count
    raw = storage.read("wal_prepares", slot * psm + 300, 8)
    storage.write("wal_prepares", slot * psm + 300,
                  bytes(b ^ 0xFF for b in raw))
    c.crash(0)
    c.heal()
    assert c.run(60000, until=lambda: all(
        r.status == "normal" and r.view >= 1 and r.op < lost
        for i, r in enumerate(c.replicas) if i not in c.crashed)), \
        c.debug_status()
    client2 = c.client(901)
    client2.request(run.m["Operation"](int(Operation.create_transfers)),
                    _transfers([(200, 2, 1, 3)]))
    assert c.run(20000, until=lambda: client2.idle), c.debug_status()
    c.settle()
    run.client = client2


def _state_sync(run):
    """A replica partitioned while two checkpoints pass (the 32-slot WAL
    wraps): it catches up by state sync."""
    c = run.cluster
    run.drive(Operation.create_accounts, _accounts([1, 2]))
    lagger = (c.replicas[0].primary_index() + 1) % 3
    c.partition(("replica", lagger))
    for k in range(36):
        run.drive(Operation.create_transfers, _transfers([(600 + k, 1, 2, 1)]))
    c.heal(("replica", lagger))
    c.settle(6000)


def _rebuild(run):
    """A replica's data file is destroyed past a WAL wrap, traffic goes
    on, and the replica rebuilds from the cluster (the in-process form of
    `recover --from-cluster`): a checkpoint installed over state sync,
    the suffix repaired, the grid certified, then a voter again."""
    c = run.cluster
    run.drive(Operation.create_accounts, _accounts([1, 2]))
    for k in range(40):
        run.drive(Operation.create_transfers, _transfers([(100 + k, 1, 2, 1)]))
    c.settle()
    victim = (c.replicas[0].primary_index() + 1) % 3
    c.destroy_data_file(victim)
    for k in range(5):
        run.drive(Operation.create_transfers, _transfers([(300 + k, 1, 2, 1)]))
    rebuilt = c.rebuild(victim)
    assert rebuilt._rebuild_synced and rebuilt._rebuild_certified
    c.settle()


def _chaos(run):
    run.drive(Operation.create_accounts, _accounts([1, 2]))
    for k in range(10):
        run.drive(Operation.create_transfers, _transfers([(1000 + k, 1, 2, 1)]))
    run.cluster.settle()


CHAOS = dict(loss_probability=0.05, duplicate_probability=0.05,
             delay_min_ns=1 * MS, delay_max_ns=40 * MS)
CASES = {
    "normal": (1, 3, None, _normal),
    "view_change": (2, 3, None, _view_change),
    "crash_restart": (3, 3, None, _crash_restart),
    "nack_repair": (21, 6, None, _nack),
    "state_sync": (28, 3, None, _state_sync),
    "rebuild": (31, 3, None, _rebuild),
    "chaos_11": (11, 3, CHAOS, _chaos),
    "chaos_12": (12, 3, CHAOS, _chaos),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_equal_to_the_jax_package(case):
    seed, count, network, scenario = CASES[case]
    verify = P_constants.VERIFY
    try:
        out = {}
        for pkg in ("P", "J"):
            run = _Run(pkg, seed, count, network)
            scenario(run)
            out[pkg] = run.result()
    finally:
        P_constants.set_verify(verify)
    p, j = out["P"], out["J"]
    assert p["replicas"] == j["replicas"]
    assert p["replies"] == j["replies"]
    assert p["states"] == j["states"]
    assert len(set(p["states"])) == 1
    assert p["now"] == j["now"]
    if case == "view_change":
        assert all(v > 0 for _, _, v, _, _, _ in p["replicas"])
    if case == "state_sync":
        assert min(ck for *_, ck in p["replicas"]) >= 32
