"""The supervisor's partitioned half (`serving.py` `attach_partitioned`,
`reshard`, the per-window ticks, the epoch's drain and digest leg, the
recovery's revert and resync, `stats()["resharding"]`) against the JAX
package's, on the CPU; and the chain graph key that carries the
ownership overlay.

Both supervisors run one script: accounts, `attach_partitioned` on a
mesh of 2 (the port's logical shards of the CPU, the JAX package's host
devices), windows through both window paths while a split migrates, an
epoch check after its flip, a merge_back drained by an epoch check
while it copies, a third migration whose copy a dispatch-exhaustion
recovery cuts (the controller reverts it, the router resyncs from the
verified base), and more windows. After every step the histories, the
counters (recoveries by cause, epochs), the ownership entries and
`stats()["resharding"]` (durations aside) are equal, and every window's
answers equal a clean oracle replay.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import serving as JS
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu.parallel import partitioned as JP
from tigerbeetle_tpu.parallel import resharding as JR
from tigerbeetle_tpu_torch import serving as TS
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.oracle.state_machine import StateMachineOracle
from tigerbeetle_tpu_torch.parallel import partitioned as TP
from tigerbeetle_tpu_torch.parallel import resharding as TR
from tigerbeetle_tpu_torch.parallel import shard_utils as TSU
from tigerbeetle_tpu_torch.trace import FlightRecorder
from tests.test_torch_partitioned import _jmesh, _tmesh

torch.set_num_threads(1)

A_CAP, T_CAP = 1 << 9, 1 << 11
HALF = 1 << 63
RETRY = dict(max_retries=2, base_delay_s=1e-4, max_delay_s=1e-3)
N_ACCTS = 40


def _port(obj):
    return getattr(TT, type(obj).__name__)(**dataclasses.asdict(obj))


def _resharding(sup) -> dict:
    r = sup.stats()["resharding"]
    return dict(r, migrations=[{k: v for k, v in m.items()
                                if k != "duration_s"}
                               for m in r["migrations"]])


class _Faults:
    """A dispatch hook that fails every attempt of the named windows."""

    def __init__(self, error):
        self.error = error
        self.fail = set()

    def __call__(self, win, what):
        if win in self.fail:
            raise self.error(f"injected at window {win}")


class _Pair:
    def __init__(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TB_TPU_FLIGHT_DIR", str(tmp_path / "jax"))
        self.hooks = (_Faults(JS.TransientDispatchError),
                      _Faults(TS.TransientDispatchError))
        common = dict(epoch_interval=3, sleep=lambda s: None)
        self.j = JS.ServingSupervisor(A_CAP, T_CAP,
                                      retry=JS.RetryPolicy(**RETRY),
                                      fault_hook=self.hooks[0], **common)
        self.t = TS.ServingSupervisor(
            A_CAP, T_CAP, retry=TS.RetryPolicy(**RETRY),
            fault_hook=self.hooks[1], device="cpu",
            flight_recorder=FlightRecorder(dump_dir=str(tmp_path)), **common)
        accts = [JT.Account(id=i, ledger=1, code=1)
                 for i in range(1, N_ACCTS + 1)]
        self.j.create_accounts(accts, 50)
        self.t.create_accounts([_port(a) for a in accts], 50)
        self.script = [("accounts", [_port(a) for a in accts], 50)]
        self.rng = np.random.default_rng(71)
        self.nid, self.ts = 10 ** 6, 10 ** 9

    def attach(self):
        self.ctl = (self.j.attach_partitioned(JP.PartitionedRouter(
            _jmesh(2), a_cap=A_CAP, t_cap=T_CAP)),
            self.t.attach_partitioned(TP.PartitionedRouter(
                _tmesh(2), a_cap=A_CAP, t_cap=T_CAP)))
        assert self.t.mirror_audit == self.j.mirror_audit == "off"
        self.check()

    def window(self, pipelined=False, fail=False):
        batches, tss = [], []
        for _ in range(2):
            evs = []
            for _i in range(8):
                dr, cr = self.rng.choice(np.arange(1, N_ACCTS + 1), 2,
                                         replace=False)
                evs.append(JT.Transfer(
                    id=self.nid, debit_account_id=int(dr),
                    credit_account_id=int(cr),
                    amount=int(self.rng.integers(1, 30)), ledger=1, code=1))
                self.nid += 1
            self.ts += 300
            batches.append(evs)
            tss.append(self.ts)
        t_batches = [[_port(e) for e in b] for b in batches]
        for h, sup in zip(self.hooks, (self.j, self.t)):
            if fail:
                h.fail.add(sup.windows_total)
        if pipelined:
            self.j.submit_transfers_window(batches, tss)
            self.t.submit_transfers_window(t_batches, tss)
            self.j.drain_pipeline()
            self.t.drain_pipeline()
        else:
            self.j.create_transfers_window(batches, tss)
            self.t.create_transfers_window(t_batches, tss)
        self.script.append(("window", t_batches, tss))
        self.check()

    def reshard(self, plan):
        self.j.reshard(JR.ReshardPlan(*plan))
        self.t.reshard(TR.ReshardPlan(*plan))
        self.check()

    def check(self):
        j, t = self.j, self.t
        assert t.history == j.history
        for k in ("recoveries", "epochs_verified", "checksum_mismatches",
                  "replayed_windows", "retries"):
            assert t.counters[k] == j.counters[k], k
        assert t.last_recovery == j.last_recovery
        if t.part_router is not None:
            assert _resharding(t) == _resharding(j)
            assert (t.part_router.ownership.entries
                    == j.part_router.ownership.entries)

    def audit(self):
        """The history against a clean oracle replay of the script."""
        sm = StateMachineOracle()
        want = []
        for kind, payload, ts in self.script:
            if kind == "accounts":
                want.append([(r.timestamp, int(r.status))
                             for r in sm.create_accounts(payload, ts)])
            else:
                want.append([[(r.timestamp, int(r.status))
                              for r in sm.create_transfers(b, t)]
                             for b, t in zip(payload, ts)])
        assert self.t.history == want


def test_supervisor_partitioned_half_equals_the_jax_packages(
        tmp_path, monkeypatch):
    p = _Pair(tmp_path, monkeypatch)
    p.attach()
    p.window()
    p.window(pipelined=True)
    # A split: the ticks copy (a conflicting window drains), double-write
    # for two windows, flip and retire; the epoch check after the flip.
    p.reshard((0, HALF - 1, 0, 1, "split"))
    guard = 0
    while p.t.resharder.stage != "done":
        p.window(pipelined=guard % 2 == 1)
        guard += 1
        assert guard < 16
    assert p.t.verify_epoch() and p.j.verify_epoch()
    p.check()
    assert [m["kind"] for m in p.t.resharder.migrations] == ["split"]
    # A merge_back drained by an epoch check while it copies.
    p.reshard((0, HALF - 1, 0, 1, "merge_back"))
    assert p.t.resharder.stage == "copy"
    assert p.t.verify_epoch() and p.j.verify_epoch()
    p.check()
    assert p.t.resharder.stage == "done"
    assert p.t.part_router.ownership.entries == ()
    p.window()
    # A migration cut by a recovery: one chunk (no conflict), then every
    # attempt of a window fails; the recovery reverts the migration and
    # resyncs, and the window re-dispatches on the rebuilt state.
    p.t.resharder.chunk_rows = p.j.resharder.chunk_rows = 1
    p.reshard((HALF, (1 << 64) - 1, 1, 0, "migrate"))
    p.window(fail=True)
    assert p.t.counters["recoveries"] == {"dispatch_exhausted": 1}
    assert p.t.resharder.stage == "aborted"
    assert [a["reason"] for a in p.t.resharder.aborts] == ["recovery"]
    assert p.t.part_router.ownership.entries == ()
    assert p.t.part_router.shard_resyncs == 1
    for _ in range(2):
        p.window()
    assert p.t.verify_epoch() and p.j.verify_epoch()
    p.check()
    p.audit()
    st = p.t.stats()
    assert st["resharding"]["stage"] == "aborted"
    assert len(st["resharding"]["migrations"]) == 2
    assert st["recoveries"] == {"dispatch_exhausted": 1}
    assert st["ledger"]["routes"]["windows"].get("partitioned_chain")


# ------------------------------------------- the chain graph's overlay key

class _RecordingGraphs:
    """A WindowGraphs stand-in that records each window's key and runs the
    call eagerly."""

    def __init__(self):
        self.keys = []

    @staticmethod
    def check_mesh(mesh):
        pass

    def run(self, key, call, state, lanes, poison=None):
        self.keys.append(key)
        return call(state, lanes, torch.zeros((), dtype=torch.bool))


def test_chain_graph_key_carries_the_ownership_overlay():
    """The body a chain graph captures depends on the overlay, so the key
    must change with `set_ownership`: a graph captured under the base map
    must not replay under a double-write or migrated overlay."""
    sm = StateMachineOracle()
    sm.create_accounts([TT.Account(id=i, ledger=1, code=1)
                        for i in range(1, 17)], 50)
    router = TP.PartitionedRouter(_tmesh(2), a_cap=A_CAP, t_cap=T_CAP)
    state = router.from_oracle(sm)
    graphs = _RecordingGraphs()
    nid = [100]

    def window():
        evs, tss = [], []
        for b in range(2):
            evs.append({k: v for k, v in _arrays(nid).items()})
            tss.append(10 ** 9 + 100 * (len(graphs.keys) * 2 + b))
        router.chain_dispatch(state, evs, tss, graphs=graphs)

    entry = (0, HALF - 1, 0, 1)
    window()
    router.set_ownership(router.ownership.with_entry(
        *entry, TSU.OVERLAY_DOUBLE_WRITE))
    window()
    router.set_ownership(router.ownership.transition(
        entry + (TSU.OVERLAY_DOUBLE_WRITE,), TSU.OVERLAY_MIGRATED))
    window()
    router.set_ownership(router.ownership.without_entry(entry + (0,)))
    window()
    keys = graphs.keys
    assert len(set(keys[:3])) == 3, keys
    assert keys[3] == keys[0]
    assert [k[-1] for k in keys] == [
        (), (entry + (TSU.OVERLAY_DOUBLE_WRITE,),),
        (entry + (TSU.OVERLAY_MIGRATED,),), ()]
    assert all(k[:3] == ("partitioned_chain", 2, keys[0][2]) for k in keys)


def _arrays(nid):
    from tigerbeetle_tpu_torch.ops.batch import transfers_to_arrays

    evs = [TT.Transfer(id=nid[0] + i, debit_account_id=1 + i % 16,
                       credit_account_id=1 + (i + 5) % 16, amount=1,
                       ledger=1, code=1) for i in range(8)]
    nid[0] += 8
    return transfers_to_arrays(evs)


@pytest.mark.parametrize("seed", [2])
def test_mesh_seed_reshard_runs_through_the_supervisor_chaos(seed):
    """The port's default chaos seed that draws the mesh scenario returns
    `reshard` beside `shard_loss` and `shard_resync`."""
    from tigerbeetle_tpu_torch.testing import chaos as TCH

    got = TCH.run_chaos_seed(seed, device="cpu")
    assert {"shard_loss", "shard_resync", "reshard"} <= set(got)
    assert got["reshard"]["aborts"] == 6
    assert got["reshard"]["migrations"] == 1
