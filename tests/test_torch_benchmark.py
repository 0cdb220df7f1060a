"""The port's `benchmark.py` and `main.py benchmark` against the JAX
package's.

Every generator makes byte-equal batches to the JAX package's: each
runner's ledger (or state machine, supervisor, admission plane) is
replaced, in both packages, by a recorder, so no JAX program compiles
and no device work runs. The port's runners then count on a small CPU
ledger what the port's oracle, fed the same batches, creates, and leave
the same state digest; `parity_config5` holds on the CPU; `main.py
benchmark --platform cpu` prints the JAX line's keys.
"""

import json

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import admission as J_admission
from tigerbeetle_tpu import benchmark as J
from tigerbeetle_tpu import main as J_main
from tigerbeetle_tpu import serving as J_serving
from tigerbeetle_tpu import state_machine as J_sm
from tigerbeetle_tpu.ops import ledger as J_ledger
from tigerbeetle_tpu_torch import admission as P_admission
from tigerbeetle_tpu_torch import benchmark as P
from tigerbeetle_tpu_torch import main as P_main
from tigerbeetle_tpu_torch import serving as P_serving
from tigerbeetle_tpu_torch import state_machine as P_sm
from tigerbeetle_tpu_torch.ops import ledger as P_ledger
from tigerbeetle_tpu_torch.ops.batch import transfers_from_arrays
from tigerbeetle_tpu_torch.ops.state_epoch import (combine,
                                                   device_state_digest,
                                                   oracle_state_digest)
from tigerbeetle_tpu_torch.oracle import StateMachineOracle
from tigerbeetle_tpu_torch.types import (Account, CreateTransferStatus,
                                         TransferFlags)

torch.set_num_threads(1)

CREATED = int(CreateTransferStatus.created)


def _same_soa(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _mk(mod, monkeypatch, name, *args):
    """The batch generator `mod.<name>` hands to _warm_and_run."""
    got = {}

    def warm_and_run(led, mk, batches, diag_key=None):
        got["mk"] = mk
        return 0, 1.0

    monkeypatch.setattr(mod, "_make_ledger", lambda *a, **k: None)
    monkeypatch.setattr(mod, "_warm_and_run", warm_and_run)
    getattr(mod, name)(*args)
    return got["mk"]


@pytest.mark.parametrize("name", ["bench_config1", "bench_config2",
                                  "bench_config_zipfian", "bench_config3"])
def test_generators_equal_the_jax_packages(name, monkeypatch):
    """The warm-up batches, then the timed ones, in the order
    _warm_and_run draws them: byte-equal SoA dicts."""
    mk_p = _mk(P, monkeypatch, name, 3)
    mk_j = _mk(J, monkeypatch, name, 3)
    for b in [*range(-P.B_CHUNK, 0), 0, 1, 2]:
        _same_soa(mk_p(b), mk_j(b))


class _RecordingLedger:
    """Stands in for a DeviceLedger: records every batch, creates all."""

    def __init__(self, *a, **k):
        self.batches = []
        _RecordingLedger.last = self

    def warm_kernels(self, *a, **k):
        pass

    def create_accounts(self, accounts, timestamp):
        self.accounts = (list(accounts), timestamp)

    def create_transfers_soa(self, ev, ts):
        self.batches.append((ev, int(ts)))
        n = len(ev["id_lo"])
        return np.full(n, CREATED, np.uint32), np.zeros(n, np.uint64)

    def resolve_windows(self, count=None):
        pass

    def fallback_stats(self):
        return {"routes": {"windows": {}}}


def test_config4_batches_equal_the_jax_packages_and_count_like_the_oracle(
        monkeypatch):
    """bench_config4 on the CPU (1,024-event pend and post/void batches
    one at a time): the same accounts and batches at the same
    timestamps as the JAX package's; the port's real run then creates
    what the oracle creates from those batches after the warm-up."""
    recorded = {}
    for mod, led_mod in ((P, P_ledger), (J, J_ledger)):
        with monkeypatch.context() as m:
            m.setattr(led_mod, "DeviceLedger", _RecordingLedger)
            mod.bench_config4(batches=2, n=128,
                              **({"device": "cpu"} if mod is P else {}))
        recorded[mod] = _RecordingLedger.last
    p, j = recorded[P], recorded[J]
    assert [a.pack() for a in p.accounts[0]] == \
        [a.pack() for a in j.accounts[0]]
    assert p.accounts[1] == j.accounts[1]
    assert len(p.batches) == len(j.batches) == 6
    for (ev_p, ts_p), (ev_j, ts_j) in zip(p.batches, j.batches):
        _same_soa(ev_p, ev_j)
        assert ts_p == ts_j

    accepted, _ = P.bench_config4(batches=2, n=128, device="cpu")
    oracle = StateMachineOracle()
    oracle.create_accounts(*p.accounts)
    want = 0
    for k, (ev, ts) in enumerate(p.batches):
        res = oracle.create_transfers(transfers_from_arrays(ev), ts)
        if k >= 2:  # the first pair is the warm-up
            want += sum(r.status == CreateTransferStatus.created
                        for r in res)
    assert accepted == want > 0
    assert P.CONFIG_DIAGNOSTICS["config4"]["host_fallbacks"] == 0


class _RecordingSM:
    def __init__(self, *a, **k):
        self.commits = []
        self.led = self
        self.fallbacks = 0
        self.state = StateMachineOracle()
        _RecordingSM.last = self

    def create_accounts(self, chunk, ts):
        self.accounts = ([a.pack() for a in chunk], ts)

    def commit(self, op, body, ts):
        self.commits.append((int(op), body, ts))

    def drain_mirror(self):
        pass

    def fallback_stats(self):
        return {"routes": {"windows": {}}}

    def shutdown_staging(self):
        pass


def test_serving_bodies_equal_the_jax_packages(monkeypatch):
    """bench_config6_serving on the CPU commits one body at a time: the
    same accounts, wire bodies and timestamps as the JAX package's."""
    recorded = {}
    for mod, sm_mod in ((P, P_sm), (J, J_sm)):
        with monkeypatch.context() as m:
            m.setattr(sm_mod, "StateMachine", _RecordingSM)
            mod.bench_config6_serving(
                batches=2, account_count=300,
                **({"device": "cpu"} if mod is P else {}))
        recorded[mod] = _RecordingSM.last
    p, j = recorded[P], recorded[J]
    assert p.accounts == j.accounts
    assert len(p.commits) == 3
    assert p.commits == j.commits


def _oracle_ledger(oracle_cls):
    class OracleLedger(oracle_cls):
        """A DeviceLedger stand-in that records the batches and answers
        from its package's oracle."""

        def __init__(self, *a, **k):
            super().__init__()
            self.batches = []
            OracleLedger.last = self

        def create_transfers(self, events, ts):
            self.batches.append(([e.pack() for e in events], ts))
            return super().create_transfers(events, ts)

        def to_host(self):
            return self

    return OracleLedger


def test_parity_config5_events_equal_the_jax_packages_and_hold(
        monkeypatch):
    from tigerbeetle_tpu.oracle import StateMachineOracle as J_Oracle

    recorded = {}
    for mod, led_mod, oracle_cls in ((P, P_ledger, StateMachineOracle),
                                     (J, J_ledger, J_Oracle)):
        fake = _oracle_ledger(oracle_cls)
        with monkeypatch.context() as m:
            m.setattr(led_mod, "DeviceLedger", fake)
            assert mod.parity_config5() is True
        recorded[mod] = fake.last.batches
    assert len(recorded[P]) == 6
    assert recorded[P] == recorded[J]
    assert P.parity_config5(device="cpu") is True


class _RecordingSupervisor:
    def __init__(self, *a, **k):
        self.led = self

    def shutdown_staging(self):
        pass


class _RecordingPlane:
    def __init__(self, sup, **k):
        self.kwargs = {n: v for n, v in k.items() if n != "clock"}
        self.submits = []
        self.pumps = 0
        _RecordingPlane.last = self

    def open_accounts(self, accounts, ts):
        self.accounts = ([a.pack() for a in accounts], ts)

    def submit(self, sid, evs, cls):
        self.submits.append((sid, cls, [e.pack() for e in evs]))

    def pump(self):
        self.pumps += 1

    def drain(self):
        pass

    def stats(self):
        return {"events_admitted": 4 * len(self.submits)}


def test_admission_requests_equal_the_jax_packages(monkeypatch):
    """bench_admission's sessions, classes and transfers, and the plane's
    parameters, equal the JAX package's."""
    recorded = {}
    for mod, adm, srv in ((P, P_admission, P_serving),
                          (J, J_admission, J_serving)):
        with monkeypatch.context() as m:
            m.setattr(adm, "AdmissionPlane", _RecordingPlane)
            m.setattr(srv, "ServingSupervisor", _RecordingSupervisor)
            st = mod.bench_admission(rounds=3)
        recorded[mod] = (_RecordingPlane.last, st)
    (p, st_p), (j, st_j) = recorded[P], recorded[J]
    assert p.submits == j.submits and len(p.submits) == 3 * 96
    assert p.accounts == j.accounts and p.pumps == j.pumps == 3
    assert [(c.name, c.priority, c.slo_ms, c.deadline_ms)
            for c in p.kwargs.pop("classes")] == \
        [(c.name, c.priority, c.slo_ms, c.deadline_ms)
         for c in j.kwargs.pop("classes")]
    assert p.kwargs == j.kwargs
    assert set(st_p) == set(st_j)


def _uniform(rng, n_batches, n, n_accounts, first_id):
    """config 2's generator at n events a batch, a linked pair in every
    fourth batch whose terminator debits a missing account."""
    evs = []
    for b in range(n_batches):
        base = first_id + b * n
        dr = rng.integers(1, n_accounts + 1, n, dtype=np.uint64)
        cr = rng.integers(1, n_accounts + 1, n, dtype=np.uint64)
        clash = dr == cr
        cr[clash] = dr[clash] % n_accounts + 1
        flags = np.zeros(n, np.uint32)
        if b % 4 == 3:
            flags[0] = int(TransferFlags.linked)
            dr[1] = n_accounts + 10**6
        evs.append(P._soa(np.arange(base, base + n), dr, cr,
                          rng.integers(1, 10**6, n), flags=flags))
    return evs


@pytest.mark.parametrize("stack", [1, 4])
def test_runners_count_like_the_oracle(stack):
    """_run_scan on a small CPU ledger, one batch a dispatch (the plain
    tier, the fallback flag threaded on the device) or as windows of 4
    through submit_window (two windows, the second of 3): the accepted
    count and the state digest equal the port's oracle's fed the same
    batches at the same timestamps; the route is recorded."""
    a_cap, n_accounts = 1 << 10, 200
    led = P._make_ledger(n_accounts, a_cap=a_cap, t_cap=1 << 14,
                         device="cpu")
    oracle = StateMachineOracle()
    oracle.create_accounts([Account(id=i, ledger=1, code=1)
                            for i in range(1, n_accounts + 1)], n_accounts)
    evs = _uniform(np.random.default_rng(2), 7, 300, n_accounts, 10**7)
    accepted, elapsed = P._run_scan(led, evs, np.uint64(10**12),
                                    stack=stack, diag_key="test")
    want = 0
    for i, ev in enumerate(evs):
        res = oracle.create_transfers(transfers_from_arrays(ev),
                                      10**12 + i * (P.N + 10))
        want += sum(r.status == CreateTransferStatus.created for r in res)
    assert accepted == want and 0 < want < 7 * 300
    assert elapsed > 0
    assert combine(device_state_digest(led.state)) == \
        combine(oracle_state_digest(oracle, a_cap))
    assert P.CONFIG_ROUTES["test"] == (
        {"route": "per_batch", "window_depths": [1]} if stack == 1
        else {"route": "chain", "window_depths": [3, 4]})
    assert led.fallbacks == 0


def test_superbatch_default_reads_the_device():
    assert P._superbatch_default(40, "cpu") == 1
    assert P._superbatch_default(40, torch.device("cpu")) == 1


def test_benchmark_command_prints_the_jax_line(monkeypatch, capsys):
    """`benchmark --platform cpu` runs config 2 (one 8,190-event batch,
    after a one-batch warm-up here) and prints one JSON line with the
    JAX command's keys; every transfer of config 2 is created."""
    monkeypatch.setattr(P, "B_CHUNK", 1)
    assert P_main.main(["benchmark", "--platform", "cpu",
                        "--transfer-count", "8190",
                        "--account-count", "100"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["transfers"] == 8190
    assert line["load_accepted_tx_per_s"] > 0 and line["seconds"] > 0
    assert P.CONFIG_ROUTES["config2"]["route"] == "per_batch"
    monkeypatch.setattr(J, "bench_config2", lambda *a, **k: (8190, 2.0))
    assert J_main.main(["benchmark", "--transfer-count", "8190"]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == list(theirs)
