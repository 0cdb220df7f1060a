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
import json

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


def test_chip_smoke_has_the_exact_path_and_sequential_phases():
    """main() runs both new phases after the earlier ones, builds
    create_seq.cu with the other kernels, and names the kernel in the
    kernels line."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in ("main_path_phase(", "config4_phase(",
                                      "exact_path_phase(", "seq_phase(")]
    assert order == sorted(order)
    assert "'name': 'create_seq'" in main
    assert "tigerbeetle_tpu_torch/csrc/create_seq.cu" in main
    build = inspect.getsource(CS.build_all)
    assert '"create_seq"' in build and "load_create_seq" in build


def test_exact_path_phase_rehearsed_on_the_cpu():
    """The exact-path phase at a small size with both ledgers on the CPU:
    every batch equal to the oracle and between the ledgers; the hard
    batches open the mirror regime, the cascade probes the device tiers
    and falls back past the 32-round tier, and the recovery batches
    return the ledger to its device tiers."""
    launches, timing = CS.exact_path_phase(
        "cpu", n_accounts=300, batch=64, setup_batches=2,
        caps=(1 << 10, 1 << 13))
    assert launches == (0, 0)  # the plain twins ran: no kernel launched
    assert timing["causes"] == {"e1_hard_flags": 1, "e3_limit": 1}
    fast, fixpoint, deep, escalations, fallbacks = timing["counters"]
    assert (fixpoint, deep, escalations) == (0, 1, 2)
    assert fallbacks == timing["mirror_batches"] - 1  # expiry is no batch
    assert [h["label"] for h in timing["hard"]] == [
        "imported chain", "repeated account id", "pair-sum overflow",
        "pendings, timeout 1 s", "expiry", "cascade (the probe)"]
    assert timing["hard"][0]["to_host_ms"] > 0


def test_seq_phase_rehearsed_on_the_cpu():
    """The sequential phase at a small size on the CPU: the mixed batches
    reach the twin (here compared with itself) and run_create_* equals
    the oracle on config-3 and config-4 batches."""
    numbers = CS.seq_phase("cpu", n_full=64, n_checked=96, n_accounts=300,
                           config3_batches=2)
    assert numbers["launches"] == 0 and numbers["max_abs_err"] == 0
    assert numbers["events"] == [64] * 4 + [44] + [64] * 5
    # Every run_create_* call recorded its own three spans.
    for k in ("prefetch_ms", "kernel_ms", "apply_ms"):
        assert len(numbers[k]) == 10 and min(numbers[k]) > 0, k
    assert 0 < min(numbers["config3_created"]) < 64
    assert 0 < numbers["config4_created"] < 64


def test_seq_plain_child_holds_the_kernel_to_the_plain_twin():
    """The full-width plain twin's child process, at 64 events on the
    CPU: its outputs equal the plain twin's run here (err 0, a time
    taken), and an output that differs fails the phase."""
    from tigerbeetle_tpu_torch.oracle import StateMachineOracle
    from tigerbeetle_tpu_torch.ops import create_kernels as CK
    from tigerbeetle_tpu_torch.ops.batch import prefetch_create_transfers

    o = StateMachineOracle()
    o.create_accounts([TT.Account(id=i, ledger=1, code=1)
                       for i in range(1, 101)], 1000)
    inputs, _ = prefetch_create_transfers(
        o, CS.config3_batch(np.random.default_rng(3), 0, 64, 100), 10**7)
    got = CK.create_transfers_seq_plain(CK.inputs_to_device(inputs, "cpu"))
    ms, err = CS.SeqPlainChild(inputs, got).finish()
    assert ms > 0 and err == 0
    bad = dict(got)
    k = next(iter(bad))
    bad[k] = bad[k].clone()
    bad[k].view(-1)[0] += 1
    with pytest.raises(RuntimeError, match="differs from the plain twin"):
        CS.SeqPlainChild(inputs, bad).finish()


@pytest.mark.parametrize("route,W", [("chain", 3), ("super", 3),
                                     ("super_deep", 2),
                                     ("super_imported", 2),
                                     ("super_balancing", 3)])
def test_window_launch_prediction_per_window(calls, route, W):
    """One window on each route calls the probe and the row gather as
    often as chip_smoke.py's window_launches predicts for one replay: a
    tier run a prepare on the chain, one run over the flat window."""
    led = DeviceLedger(a_cap=1 << 10, t_cap=1 << 14, device="cpu")
    led.create_accounts([TT.Account(id=i, ledger=1, code=1)
                         for i in range(1, 65)], 10**11)
    rng = np.random.default_rng(9)
    evs = [CS.uniform_batch(rng, 10**6 + 100 * b, 50, 64) for b in range(W)]
    if route == "super_deep":
        # A post in prepare 1 of a pending made in prepare 0.
        evs[0]["flags"][0] = np.uint32(int(TT.TransferFlags.pending))
        evs[1]["pid_lo"][0] = evs[0]["id_lo"][0]
        evs[1]["flags"][0] = np.uint32(
            int(TT.TransferFlags.post_pending_transfer))
        for k in ("dr_lo", "cr_lo", "amt_lo", "ledger", "code"):
            evs[1][k][0] = 0
    if route == "super_imported":
        for b, ev in enumerate(evs):
            ev["flags"][:] = np.uint32(int(TT.TransferFlags.imported))
            ev["ts"] = np.arange(1, 51, dtype=np.uint64) + 10**11 + 100 * b
    if route == "super_balancing":
        evs[2]["flags"][7] = np.uint32(int(TT.TransferFlags.balancing_debit))
    tss = [10**12 + 1000 * b for b in range(W)]
    before = dict(calls)
    led.create_transfers_window(evs, tss, all_or_nothing=route == "super")
    probes, gathers = CS.window_launches(route, W)
    assert {k: calls[k] - before[k] for k in calls} == {
        "probe": probes, "gather": gathers}
    assert led.window_routes == {route: 1} and led.fallbacks == 0
    assert led.windows.eager == {(route, W, 1024): 1}
    # Every later window of the key is one replay on the card: the
    # launches a replay runs are the wrappers' calls of that first run.
    assert CS.graph_launches(led.windows) == ((probes, gathers),
                                              (probes, gathers))


def test_config2_window_phase_rehearsed_on_the_cpu(calls):
    """The config-2 window phase at a small size on the CPU: checked
    windows equal between two ledgers, the timed windows' results equal
    to the per-batch path and the eager chain function; the wrappers'
    calls are the phase's prediction."""
    numbers = CS.config2_window_phase(
        "cpu", n_accounts=300, batch=64, w_checked=3, w_timed=4,
        timed_windows=2, caps=(1 << 10, 1 << 14))
    want = [a + b for a, b in zip(numbers["launches_counted"],
                                  numbers["cpu_ref_calls"])]
    assert [calls["probe"], calls["gather"]] == want
    assert numbers["launches_counted"] == numbers["launches_ran"]
    assert numbers["transfers_per_s"] > 0 and numbers["idle_share"] is None


def test_config4_window_phase_rehearsed_on_the_cpu(calls):
    numbers = CS.config4_window_phase(
        "cpu", batch=64, pairs=2, n_checked=2, n_timed=2,
        caps=(1 << 10, 1 << 14))
    want = [a + b for a, b in zip(numbers["launches_counted"],
                                  numbers["cpu_ref_calls"])]
    assert [calls["probe"], calls["gather"]] == want
    assert numbers["graphs"] == {"eager": 1, "captures": 0, "replays": 0}
    assert numbers["created_per_s"] > 0


def test_window_fallback_phase_rehearsed_on_the_cpu():
    """The fallback windows against a second ledger and the port's
    oracle: the window with a balancing prepare runs whole on
    super_balancing (the JAX ledger's route for it), and the poisoned
    successor replays."""
    out = CS.window_fallback_phase("cpu", n_accounts=300, batch=64,
                                   caps=(1 << 10, 1 << 14))
    routes, chain_fb, last, _, window_fb = out["balancing"]
    assert routes == {"super_balancing": 1}
    assert chain_fb == {} and window_fb == 0
    routes, chain_fb, _, _, window_fb = out["poisoned"]
    assert routes["chain"] >= 2 and chain_fb["e2_collision"] >= 1


def test_chip_smoke_runs_the_window_phases_last():
    """main() runs the three window phases after the earlier ones and
    prints their lines before the kernels line."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "seq_phase(", "config2_window_phase(", "config4_window_phase(",
        "window_fallback_phase(", "'config2_window'", "'kernels'")]
    assert order == sorted(order)


def test_imported_phase_rehearsed_on_the_cpu(calls):
    """The imported phase at a small size with both ledgers on the CPU:
    every batch and window equal to the CPU ledger's and the oracle's,
    the extras batch's regress, key_max, collision and closing lanes as
    the script expects (the closing pending escalating once to the
    imported fixpoint tier), the windows on super_imported, the chain
    batch on the exact path; the wrappers' calls are the tier runs' and
    the windows' prediction."""
    numbers = CS.imported_phase("cpu", n_accounts=300, batch=256,
                                n_checked=3, n_timed=2, w=3, w_checked=2,
                                w_timed=2, caps=(1 << 10, 1 << 15))
    assert numbers["routes"] == {"super_imported": 5}
    fast, fixpoint, deep, escalations, fallbacks = numbers["counters"]
    assert (fixpoint, deep, escalations, fallbacks) == (1, 0, 1, 0)
    assert numbers["batch_ms"] > 0 and numbers["window_ms"] > 0
    assert numbers["batch_idle_share"] is None


def test_balancing_phase_rehearsed_on_the_cpu(calls):
    """The balancing phase at a small size on the CPU: every pend batch
    on the balancing tier, the windows on super_balancing two deep, all
    equal to the CPU ledger's and the oracle's, none on the mirror."""
    numbers = CS.balancing_phase("cpu", batch=256, n_checked=3, n_timed=2,
                                 pairs=2, w_checked=2, w_timed=2,
                                 caps=(1 << 10, 1 << 15))
    assert numbers["routes"] == {"super_balancing": 4}
    assert numbers["window_fallbacks"] == 0
    assert all(set(r) == {"balancing"} for r in numbers["pend_runs"])
    assert numbers["counters"][4] == 0
    assert numbers["window_ms"] > 0 and numbers["pend_ms"] > 0


def test_balancing_pair_marks_one_pend_event_in_eight():
    rng = np.random.default_rng(1)
    TF = TT.TransferFlags
    pend, rev, _ = CS.balancing_pair(rng, 10**7, TF, 64)
    bal = (pend["flags"] & np.uint32(TF.balancing_debit
                                     | TF.balancing_credit)) != 0
    assert bal.tolist() == [i % CS.BAL_EVERY == 0 for i in range(64)]
    assert (pend["amt_lo"][bal] == CS.BAL_AMOUNT).all()
    assert (rev["pid_lo"][bal] == pend["id_lo"][bal]).all()
    _, rev_w, _ = CS.balancing_pair(np.random.default_rng(1), 10**7, TF, 64,
                                    window=True)
    assert (rev_w["pid_lo"][bal] == 0).all()
    assert (rev_w["flags"][bal] == 0).all()


def test_serving_phase_rehearsed_on_the_cpu(calls):
    """The serving phase at a small size on the CPU: StateMachine on the
    device engine (its ledger on the CPU) beside the CPU oracle engine,
    every reply equal and the mirror's digest equal to the device's
    where the phase checks it; the windows on the chain route (the ring
    kernels with recycle_events), one hard body on the mirror, every
    query answered; then the kernel engine's commits. The wrappers'
    calls include one row gather a write-through delta that fetched
    transfer rows."""
    numbers = CS.serving_phase("cpu", n_accounts=300, body=120, n_checked=2,
                               n_timed=2, w=3, w_sync=3, w_piped=2,
                               c4_pairs=1, n_kernel=1,
                               caps=(1 << 10, 1 << 15))
    assert numbers["routes"] == {"chain": 12}
    assert numbers["counters"][4] == 1           # the hard body
    assert numbers["delta_gathers"] > 0
    assert calls["gather"] >= numbers["delta_gathers"]
    assert all(numbers["query_reply_bytes"].values())
    assert set(numbers["pipelined"]) == {"staged", "staged_ring",
                                         "inline_ring"}
    assert numbers["pipelined"]["staged"]["staged"] == 2
    assert numbers["pipelined"]["inline_ring"]["staged"] == 0
    assert numbers["pipelined"]["inline_ring"]["host_stall_fraction"] == 1.0
    assert numbers["d2h_bytes_per_batch"] > 0
    assert numbers["bodies_checked_against_cpu"] > 40


def test_chip_smoke_runs_the_serving_phase_last():
    """main() runs the serving phase after the balancing phase and
    prints its line before the kernels line, whose three kernels carry
    the serving phase's launches."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "balancing_phase(", "serving_phase(", "'serving'", "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_serving'") == 4



def test_supervisor_phase_rehearsed_on_the_cpu(calls):
    """The supervisor phase at a small size on the CPU: (a) clean windows
    of 2 and 4 prepares, synchronous and pipelined, beside a bare
    write-through ledger, with epochs verified and zero recoveries; (b)
    the in-place bit flip caught by the state digest, the poisoned chunk
    by the spot audit, a dispatch retried within its budget and one
    recovered past it, a fallback storm, each recovered to parity; (c) a
    chaos seed equal on the "card" (here the CPU) and the CPU; (d) the
    admission plane conserving every request. Every VERIFY audit's
    lookups call the probe and the row gather."""
    numbers = CS.supervisor_phase(
        "cpu", n_accounts=100, body=64, caps=(1 << 10, 1 << 14),
        widths=(2, 4), chaos_seeds=(3,), admission=dict(rounds=4))
    clean, faults = numbers["clean"], numbers["faults"]
    assert clean["epochs_verified"] == 2
    assert clean["routes"] == {"chain": 12}
    assert clean["staging"]["staged"] == 4
    for w in (2, 4):
        assert sorted(clean[w]["verify_parts_ms"]) == sorted(
            ("drain", "replay", "device_digest", "oracle_digest",
             "mirror_audit"))
        assert len(clean[w]["sync_ms"]["supervisor"]) == 2
    assert faults["counters"]["recoveries"] == {
        "state_digest": 1, "mirror_divergence": 1, "dispatch_exhausted": 1}
    assert faults["counters"]["retries"] == 5
    assert faults["counters"]["replayed_windows"] == 4
    assert [w[1] for w in faults["windows"]] == [
        "recovered", "eager", "eager", "recovered", "eager", "recovered",
        "host", "eager"]
    assert [r["cause"] for r in faults["recoveries"]] == [
        "dispatch_exhausted", "state_digest", "mirror_divergence"]
    assert numbers["chaos"][3]["recoveries"] == {}
    assert numbers["admission"]["conservation"]["ok"]
    assert numbers["flight_dumps"] == 3
    assert calls["probe"] > 0 and calls["gather"] > 0


def test_chip_smoke_runs_the_supervisor_phase_last():
    """main() runs the supervisor phase after the serving phase and prints
    its line before the kernels line; the probe and the row gather carry
    its launches."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "serving_phase(", "supervisor_phase(", "'supervisor'", "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_supervisor'") == 2


def test_durable_phase_rehearsed_on_the_cpu(calls):
    """The durable phase on the CPU at the card's plan, with small bodies
    (`TEST_LAYOUT`, 200 accounts, 33 bodies of 100 events, windows of 4,
    a checkpoint every 16 ops): every reply equal to the oracle engine's,
    the data file equal byte for byte to the CPU device engine's after
    each of the two checkpoints, the second at 32, where the forest's
    first bar has ended, both flush paths taken, reads served from the forest,
    the restart's digest and replayed journal held. The device tiers and
    the delta gathers call the probe and the row gather."""
    from tigerbeetle_tpu_torch.vsr.storage import TEST_LAYOUT

    numbers = CS.durable_phase(
        "cpu", n_accounts=200, body=100, n_ops=CS.DU_OPS, w=CS.DU_W,
        interval=CS.DU_CHECKPOINT, n_after=CS.DU_AFTER, n_lookups=64,
        turns=CS.DU_TURNS, layout=TEST_LAYOUT, caps=(1 << 10, 1 << 14))
    assert numbers["ops"] == 2 + 33 + 1 + 2     # accounts, bodies, pulse
    assert [kind for kind, _ in numbers["plan"]] == [
        "timed", "closing", "imported", "resolve", "plain", "pipelined",
        "window", "hard", "resolve", "pulse", "plain", "journal"]
    assert [c["op"] for c in numbers["checkpoints"]] == [16, 32]
    assert len(numbers["zone_check_ms"]) == 2
    assert numbers["flush_ms_columns"] and numbers["flush_ms_object"]
    assert len(numbers["commit_ms_forest"]) == len(
        numbers["commit_ms_bare"]) == 2
    assert sorted(numbers["query_ms"]) == sorted(
        ("get_account_transfers", "get_account_balances", "query_accounts",
         "query_transfers", "get_change_events"))
    assert numbers["tree_rows"]["transfers"] > 2000
    assert numbers["tree_rows"]["xfer_by_imported"] > 0
    assert numbers["tree_rows"]["xfer_by_closing"] > 0
    assert numbers["tree_rows"]["expiry"] >= 0
    assert calls["probe"] > 0 and calls["gather"] > 0


def test_chip_smoke_runs_the_durable_phase_after_the_supervisor():
    """main() runs the durable phase after the supervisor phase, prints
    its line before the kernels line, and every kernel carries its
    launches on it."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "supervisor_phase(", "durable_phase(", "'durable'", "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_durable'") == 4


def test_replica_phase_rehearsed_on_the_cpu(calls):
    """The replica phase at a small size on the CPU: `format`, `start
    --platform cpu --small` in a child process on the native storage
    engine, 4 clients of 5 bodies of 100 events, the SIGKILL once a
    client holds op 19's reply (three past the checkpoint at 16) and the
    restart replaying the WAL suffix, an expiry pulse, the reads and the
    duplicate, `inspect --digest`, every reply equal to the CPU oracle
    twin's and the checkpoint's trees to its; a 3-replica cluster of
    device engines (its crashed primary catching up through commit
    windows) equal to an oracle cluster."""
    numbers = CS.replica_phase(
        "cpu", n_accounts=64, body=100, n_clients=4, n_bodies=5,
        kill_at=19, rc_ops=8, rc_body=50, rc_crash_at=4)
    assert numbers["ops"] >= 1 + 20 + 3     # accounts, bodies, reads
    assert numbers["replayed_ops"] >= 1
    opened = numbers["open_restart"]
    assert opened["native"] and opened["aio"] and opened["engine"] == "device"
    assert opened["op_checkpoint"] == 16
    assert max(numbers["windows_cluster"]) >= 1
    assert numbers["cluster"]["view"] >= 1
    assert sorted(numbers["reads_ms"]) == [
        "get_account_transfers", "lookup_accounts", "lookup_transfers"]
    assert numbers["windows_server"] and numbers["checkpoint_ms"]
    assert numbers["pulse_ops"]
    assert calls["probe"] > 0 and calls["gather"] > 0


def test_chip_smoke_runs_the_replica_phase_last():
    """main() runs the replica phase after the durable phase, prints its
    line and the phases' seconds before the kernels line, and every
    kernel carries the replica path's launches on it."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "durable_phase(", "replica_phase(", "'replica'", "'phase_seconds'",
        "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_replica':") == 4


def test_benchmark_phase_rehearsed_on_the_cpu(calls, monkeypatch):
    """The benchmark phase at a small size on the CPU: `main.main(
    ["benchmark", ...])` uniform and Zipfian (one 8,190-event batch each
    after a one-batch warm-up, one batch a dispatch on the CPU), every
    transfer accepted with no fallback and debits equal to credits;
    parity_config5 true; bench_config6_serving accepting every transfer
    of its 2 bodies."""
    from tigerbeetle_tpu_torch import benchmark

    monkeypatch.setattr(benchmark, "B_CHUNK", 1)
    numbers = CS.benchmark_phase("cpu", transfers=CS.BATCH,
                                 serving_batches=2)
    for label in ("uniform", "zipfian"):
        got = numbers[label]
        assert got["transfers"] == CS.BATCH
        assert got["route"] == "per_batch" and got["window_depths"] == [1]
        assert got["load_accepted_tx_per_s"] > 0
    assert numbers["serving"]["transfers"] == 2 * (CS.BATCH - 1)
    assert numbers["card"] == "CPU"
    assert calls["probe"] > 0 and calls["gather"] > 0


def test_chip_smoke_runs_the_benchmark_phase_after_the_replica_phase():
    """main() runs the benchmark phase after the replica phase and
    prints its line before the phases' seconds and the kernels line,
    whose probe and row-gather entries carry its launches."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "replica_phase(", "benchmark_phase(", "'benchmark'",
        "'phase_seconds'", "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_benchmark':") == 2


def test_drivers_phase_rehearsed_on_the_cpu(calls, monkeypatch):
    """The drivers phase at one seed a part on the CPU: a device-engine
    and a kernel-engine VOPR seed each equal to its oracle twin (summary
    and audited pairs), the fuzzers of the phase at a few iterations,
    `cfo --max-runs 8 --seed 7 --platform cpu` through the module's
    command line with the counts the JAX package's selection gives, and
    `devhub` over the benchmark line and cfo's artifact. The device seed
    and the device_ledger fuzzer reach the probe's and the row gather's
    plain twins, the kernel seed and the state_machine fuzzer the
    sequential kernel's."""
    from tigerbeetle_tpu_torch.ops import create_seq

    seq = []
    run = create_seq._run

    def counted(kind, *args):
        seq.append(kind)
        return run(kind, *args)

    monkeypatch.setattr(create_seq, "_run", counted)
    numbers = CS.drivers_phase(
        "cpu", {"value": 1.0, "launches": [1, 2]}, device_seeds=(626,),
        kernel_seeds=(101,), fuzz_runs=(("device_ledger", 4, 3),
                                        ("state_machine", 9, 5),
                                        ("durability", 1, 2),
                                        ("storage_faults", 1, 1)))
    assert [(r["seed"], r["engine"]) for r in numbers["vopr"]] == [
        (626, "device"), (101, "kernel")]
    assert [r["audited"] for r in numbers["vopr"]] == [34, 51]
    assert [f["name"] for f in numbers["fuzz"]] == [
        "device_ledger", "state_machine", "durability", "storage_faults"]
    assert numbers["cfo"]["counts"] == CS.CFO_COUNTS
    assert numbers["launches"] == (0, 0, 0)    # plain twins on the CPU
    assert numbers["card"] == "CPU"
    assert calls["probe"] > 0 and calls["gather"] > 0
    assert len(seq) > 0


def test_chip_smoke_runs_the_drivers_phase_after_the_benchmark_phase():
    """main() runs the drivers phase on the benchmark phase's line,
    prints its line before the phases' seconds and the kernels line, and
    every kernel carries the drivers phase's launches; the phase holds
    the JAX package's soak seeds and test sizes."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "benchmark_phase(", "drivers_phase(dev, bm)", "'drivers'",
        "'phase_seconds'", "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_drivers':") == 4
    assert CS.DV_DEVICE_SEEDS == (515, 626)
    assert CS.DV_KERNEL_SEEDS == (101, 202)
    assert ("device_ledger", 4, 15) in CS.DV_FUZZ
    assert ("state_machine", 9, 30) in CS.DV_FUZZ
    assert not hasattr(CS, "test_drivers_phase")


def test_observatory_phase_rehearsed_on_the_cpu(calls):
    """The observatory phase at a small size on the CPU: (a) profiled
    chain windows of 2 and per-batch windows land a series for each
    route, the cost model's flat and chain rows and finite roofline
    fractions, and a Chrome trace; (b) the budget's audit green, static
    equal to measured with the worst-case pack staged, the leak's three
    REDs; (c) the page alert fired, resolved, its disabled arm silent;
    (d) the observatory's own time within the budget's ceiling (the
    on-against-off median is held on the card only)."""
    numbers = CS.observatory_phase(
        "cpu", caps=(1 << 10, 1 << 13), n_accounts=100, body=64, w=2,
        chain_windows=3, flat_windows=2, pairs=1)
    prof = numbers["profiler"]
    assert {s.split("route:")[1].split(",")[0]
            for s in prof["series"]} >= {"chain", "per_batch"}
    assert set(prof["fractions"]) == {"flat", "chain"}
    assert prof["capture_trace_events"] > 0
    assert prof["launches"] == (0, 0)          # plain twins on the CPU
    mem = numbers["memwatch"]
    assert mem["leak_reds"] == 3 and mem["observations"] >= 1
    # The budget also pins the partitioned attach mode's state and
    # telemetry block, which a single-chip ledger does not hold.
    from tigerbeetle_tpu_torch.trace.memwatch import load_budget
    pins = load_budget()["components"]
    assert mem["worst_case_bytes"] == mem["budget_bytes"] - (
        pins["partitioned_state"] + pins["telemetry_block"])
    assert mem["device_memory_stats"][0]["stats"] is None
    assert numbers["alerts"]["fired"] == 1
    assert numbers["alerts"]["resolved_tick"] is not None
    assert numbers["overhead"]["ratio_max"] == 1.05
    assert calls["probe"] > 0 and calls["gather"] > 0


def test_sharded_phase_rehearsed_on_the_cpu():
    """The sharded phase at a small size on the CPU: meshes of 1 and 8
    logical CPU shards, every mode run, each step equal to the
    single-chip step and the CPU twin; both shard-loss seeds reroute
    twice."""
    numbers = CS.sharded_phase("cpu", caps=(1 << 10, 1 << 13),
                               n_accounts=100, batch=200)
    labels = [s["label"] for s in numbers["steps"]]
    assert labels == ["config2", "config2", "config4_pend",
                      "config4_post_void", "balancing", "imported"]
    assert all(s["created"] > 0 for s in numbers["steps"])
    assert not any(s["fell_back"] for s in numbers["steps"])
    assert set(numbers["stats"]) == {"sharded_1", "sharded_8", "single",
                                     "cpu_twin"}
    assert numbers["stats"]["single"]["shard_loss_reroutes"] == 6
    assert numbers["stats"]["sharded_8"]["shard_loss_reroutes"] == 0
    assert (numbers["escalations"]["sharded_8"]
            == numbers["escalations"]["cpu_twin"])
    assert numbers["launches"] == (0, 0)        # plain twins on the CPU
    assert numbers["predicted"][0] > 0
    assert all(v["reroutes"] == 2 and v["devices"] == 8
               for v in numbers["shard_loss"].values())


def test_sharded_launch_prediction():
    """A sharded step launches a probe a shard and the per-event stage's
    two gathers a shard beside the tier's own (the CPU counts of
    tests/test_torch_sharded.py)."""
    assert CS.sharded_launches("plain", 8) == (8, 20)
    assert CS.sharded_launches("fixpoint", 1) == (1, 7)
    assert CS.sharded_launches("imported", 2) == (2, 8)
    assert CS.sharded_launches("balancing", 8) == (8, 21)


def test_chip_smoke_runs_the_observatory_and_sharded_phases_last():
    """main() runs the observatory and sharded phases after the drivers
    phase, prints their lines before the phases' seconds and the kernels
    line, and the probe and the row gather carry their launches."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "drivers_phase(dev, bm)", "observatory_phase(dev)",
        "sharded_phase(dev)", "'observatory'", "'sharded'",
        "'phase_seconds'", "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_sharded':") == 2
    assert main.count("'launches_observatory':") == 2
    assert CS.SH_MESHES == (1, 8)


def test_partitioned_phase_rehearsed_on_the_cpu():
    """The partitioned phase at a small size on the CPU: 8 logical CPU
    shards, 3 chain windows of 3 (eager on the CPU), a window poisoned at
    prepare 1 and one behind it (both replayed), a balancing, an imported
    and a plain per-batch prepare, every result and digest equal to the
    oracle's; the first window's telemetry equal to the host count; both
    resync seeds resync once; the bytes a shard; and the wrappers' calls
    (the plain twins' on the CPU) equal to what partitioned_launches
    predicts for the calls the path made."""
    numbers = CS.partitioned_phase("cpu", caps=(1 << 10, 1 << 14),
                                   n_accounts=100, batch=200, w=3,
                                   windows=3, poison_at=1)
    assert numbers["window_kinds"] == ["eager"] * 3
    assert numbers["launches"] == numbers["predicted"]
    assert numbers["launches"][0] > 0 and numbers["launches"][1] > 0
    # (a)'s three windows of three plain prepares, as the route predicts.
    p, g = CS.partitioned_launches("plain", 8)
    assert tuple(numbers["launches_a"]) == (9 * p, 9 * g)
    # The ledger's window graphs ran (a)'s 3 windows and (b)'s 2, eagerly.
    assert tuple(numbers["graph_counted"]) == (15 * p, 15 * g)
    assert numbers["graph_ran"] == numbers["graph_counted"]
    assert numbers["poison_causes"] == [None, "e3_limit", "forced"]
    assert numbers["stats"]["host_fallbacks"] == 0
    assert numbers["stats"]["escalations"] == 1
    assert set(numbers["step_ms"]) == {"balancing", "imported", "plain"}
    assert all(v["resyncs"] == 1 and v["devices"] == 8
               for v in numbers["resync"].values())
    b = numbers["bytes"]
    assert b["partitioned_per_shard"] * 8 == \
        b["components"]["partitioned_state"]
    assert b["partitioned_per_shard"] <= (b["replicated"] // 8
                                          + b["replicated"] // 50)


def test_partitioned_launch_prediction():
    """A partitioned prepare launches the mode's probe once (the judge on
    the mini-state) and 3S + G + 6 gathers on S shards (the cost model's
    CPU count on 8 shards: 34 a plain prepare)."""
    assert CS.partitioned_launches("plain", 8) == (1, 34)
    assert CS.partitioned_launches("fixpoint", 8) == (1, 35)
    assert CS.partitioned_launches("imported", 2) == (1, 16)
    assert CS.partitioned_launches("balancing", 1) == (1, 14)
    assert CS.window_launches("partitioned_chain", 8) == (8, 8 * 34)


def test_chip_smoke_runs_the_partitioned_phase_last():
    """main() runs the partitioned phase after the sharded phase, prints
    its line before the phases' seconds and the kernels line, and the
    probe and the row gather carry its launches."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "sharded_phase(dev)", "partitioned_phase(dev)", "'sharded'",
        "'partitioned'", "'phase_seconds'", "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_partitioned':") == 2
    assert main.count("'ran_partitioned_windows':") == 2
    assert (CS.PT_SHARDS, CS.PT_W, CS.PT_WINDOWS, CS.PT_POISON_AT) == \
        (8, 8, 4, 3)
    assert CS.PT_RESYNC_SEEDS == (2, 10)


def test_reshard_phase_rehearsed_on_the_cpu():
    """The reshard phase at a small size on the CPU: a supervisor on 8
    logical CPU shards, 2 windows of 3 prepares, a split and its
    merge_back driven to done by the windows' ticks (3 windows each: the
    conflicting window drains the copy, two double-write windows, the flip
    and retire), every controller call that writes the state equal to the
    CPU twin's, a corrupted chunk aborting the next migration at its flip
    when the epoch check drains it (digest_mismatch, ownership at the
    base), a window after it; every epoch verified; both chaos seeds
    equal on the two runs; the two-process leg "ok"; and the wrappers'
    calls equal to what partitioned_launches and RESHARD_GATHERS
    predict."""
    numbers = CS.reshard_phase("cpu", caps=(1 << 10, 1 << 14),
                               n_accounts=100, batch=200, w=3)
    labels = [x["label"] for x in numbers["windows"]]
    assert labels == ["warm 0", "warm 1"] + [
        f"(a) {m} {k}" for m in ("split", "merge_back") for k in range(3)] + [
        "(b) after"]
    assert [x["overlay_before"] for x in numbers["windows"][2:5]] == [
        "base", "0->1:double_write", "0->1:double_write"]
    assert numbers["windows"][4]["overlay"] == "0->1:migrated"
    assert numbers["windows"][-1]["stage"] == "aborted"
    assert all(x["kind"] == "eager" for x in numbers["windows"])
    ticks = [x["tick_ms"] > 0 for x in numbers["windows"]]
    assert ticks == [False, False] + [True] * 6 + [False]
    res = numbers["resharding"]
    assert [m["kind"] for m in res["migrations"]] == ["split", "merge_back"]
    assert [a["reason"] for a in res["aborts"]] == ["digest_mismatch"]
    assert [c[:2] for c in numbers["twin_compared"]] == [
        ("on_window", "copy"), ("on_window", "double_write")] * 2 + [
        ("drain", "copy")]
    assert numbers["launches"] == tuple(numbers["predicted"])
    assert numbers["kernel_calls"] == {"_finalize_shard": 2 * 3,
                                       "_evict_range": 2 * 3}
    p, g = CS.partitioned_launches("plain", 8)
    assert tuple(numbers["window_pred"]) == (9 * 3 * p, 9 * 3 * g)
    assert numbers["graph_evictions"] == 0
    assert set(numbers["stage_ms"]) == {
        "_take_snapshot", "copy_chunk", "_activate_double_write", "flip",
        "_retire"}
    assert set(numbers["verify_ms"]) == {"split", "merge_back", "negative",
                                         "negative_drain", "final"}
    assert sorted(numbers["chaos"]) == [2, 10]
    assert all(v["aborts"] == 6 for v in numbers["chaos"].values())
    assert numbers["two_process"]["verdict"] == "ok"
    assert numbers["two_process"]["launches"] == (0, 0)


def test_reshard_gathers_read_from_the_code():
    """RESHARD_GATHERS counts the row-gather calls of the resharding
    kernels: their calls through the wrapper's COST hook on the CPU."""
    import torch as _torch

    from tigerbeetle_tpu_torch.oracle.state_machine import \
        StateMachineOracle
    from tigerbeetle_tpu_torch.parallel import resharding as RS
    from tigerbeetle_tpu_torch.parallel.partitioned import \
        partitioned_from_oracle
    from tigerbeetle_tpu_torch.parallel.shard_utils import Mesh
    from tigerbeetle_tpu_torch.types import Account

    sm = StateMachineOracle()
    sm.create_accounts([Account(id=i, ledger=1, code=1)
                        for i in range(1, 33)], 50)
    state = partitioned_from_oracle(sm, Mesh(["cpu"] * 2), 1 << 8, 1 << 9)
    o = _torch.zeros(1, dtype=_torch.int64)
    with CS._WrapperCalls() as calls:
        RS._finalize_shard(state[1], o, o, 0)
        assert calls.n == {"ht_probe": 0,
                           "row_gather": CS.RESHARD_GATHERS["_finalize_shard"]}
        RS._evict_range(state[0], 0, 1 << 63, 2, 0)
        assert calls.n["row_gather"] == sum(CS.RESHARD_GATHERS.values())
        assert calls.n["ht_probe"] == 0


def test_chip_smoke_runs_the_reshard_phase_last():
    """main() runs the reshard phase after the partitioned phase, prints
    its line before the phases' seconds and the kernels line, and the
    probe and the row gather carry its launches."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "partitioned_phase(dev)", "reshard_phase(dev)", "'partitioned'",
        "'reshard'", "'phase_seconds'", "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_reshard':") == 2
    assert main.count("'launches_reshard_two_process':") == 2
    assert (CS.RS_SHARDS, CS.RS_W, CS.RS_WARM) == (8, 4, 2)
    assert CS.RS_CHAOS_SEEDS == (2, 10)


def _replay_scenario(names):
    """A gate scenario that emits once each catalog event of `names` that
    no scenario before it emitted."""
    from tigerbeetle_tpu_torch.trace import Event, EventKind

    def _scenario_replay(col):
        seen = col.emitted()
        t = col.make(0)
        for e in Event:
            if e.name not in names or e.name in seen:
                continue
            if e.kind is EventKind.span:
                t.record_span(e, t.now_ns(), 1000)
            elif e.kind is EventKind.counter:
                t.count(e)
            elif e.kind is EventKind.gauge:
                t.gauge(e, 1.0)
            else:
                t.observe(e, 1.0)
    return _scenario_replay


def test_trace_coverage_phase_rehearsed_on_the_cpu(calls, monkeypatch):
    """The gate phase on the CPU at a small size: five of the gate's
    scenarios (the staging plane's device ledger among them), each timed
    with its new events, and a replay of the rest of the catalog; the
    gate holds, then the metrics leg. With the catalog one event short,
    the phase fails."""
    from tigerbeetle_tpu_torch.testing import trace_coverage as TCV
    from tigerbeetle_tpu_torch.trace import Event

    names = ("rollback_and_config", "bus_pair", "overlap", "slo",
             "observatory")
    catalog = {e.name for e in Event}
    real = tuple(getattr(TCV, f"_scenario_{n}") for n in names)
    monkeypatch.setattr(TCV, "SCENARIOS",
                        real + (_replay_scenario(catalog),))
    numbers = CS.trace_coverage_phase("cpu")
    rows = numbers["scenarios"]
    assert [r["name"] for r in rows] == list(names) + ["replay"]
    assert {"rollbacks", "bus_send", "window_stage", "slo_breach",
            "alert_fired"} <= set().union(*(r["new"] for r in rows[:-1]))
    assert 0 < len(rows[-1]["new"]) < 56
    assert numbers["catalog"] == numbers["emitted"] == 56
    assert calls["probe"] > 0 and calls["gather"] > 0
    monkeypatch.setattr(TCV, "SCENARIOS",
                        (_replay_scenario(catalog - {"commit_windows"}),))
    with pytest.raises(RuntimeError, match="coverage_main returned 1"):
        CS.trace_coverage_phase("cpu")


def test_clients_phase_rehearsed_on_the_cpu():
    """The clients phase at a small size on the CPU: `start --platform
    cpu --small` on the device engine beside an oracle-engine twin, the C
    client's 64 accounts, 2 bodies of 100 transfers, a warm-up and 4
    timed one-transfer requests and the lookups (every reply equal to the twin's,
    timestamps aside), the C++ example built and run against the
    server, `main.py clients` byte-equal to the committed tree."""
    numbers = CS.clients_phase("cpu", n_accounts=64, body=100, n_bodies=2,
                               n_small=4)
    assert numbers["requests"] == 1 + 2 + 1 + 4 + 2
    assert numbers["files_generated"] == 36
    assert len(numbers["body_latency_ms"]) == 2
    assert numbers["small_latency_ms"]["n"] == 4
    assert numbers["twin_small_latency_ms"]["n"] == 4
    assert sorted(numbers["lookup_latency_ms"]) == [
        "lookup_accounts", "lookup_transfers"]
    assert set(numbers["phase_seconds"]) == {
        "format", "start", "wait", "requests_card", "requests_twin",
        "cpp_build", "cpp_run", "generate"}


def test_chip_smoke_runs_the_gate_and_clients_phases_last():
    """main() starts the clients phase's servers before the reshard
    phase, runs the gate and the clients phases after it and stops the
    servers, prints their lines before the phases' seconds and the
    kernels line, and every kernel carries their launches."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "ClientsRig(dev)", "reshard_phase(dev)", "trace_coverage_phase(dev)",
        "clients_phase(dev, rig)", "rig.close()", "'reshard'",
        "'trace_coverage'", "'clients'", "'phase_seconds'", "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_trace_coverage':") == 4
    assert main.count("'launches_clients_server':") == 4


def test_static_phase_rehearsed_on_the_cpu():
    """Phase 26 on the CPU, its child process included: the four passes
    clean over the 18 entries, the seven negative proofs red, every capture
    window eager on the CPU, the census calling what a plain tier run
    launches; a verdict with a proof that did not red fails the phase."""
    child = CS.StaticChild("cpu")
    got = child.finish()

    class Done:
        def __init__(self, status):
            self.status = status

        def finish(self):
            return (self.status,) + got[1:]

    numbers = CS.static_phase("cpu", Done(got[0]))
    assert numbers["findings"] == {"determinism": 0, "host": 0,
                                   "retrace": 0, "sharding": 0}
    assert len(numbers["negatives"]) == 7
    assert all(numbers["negatives"].values())
    assert numbers["n_entries"] == 18
    assert numbers["tracebudget"] == "tracebudget_r01.json"
    assert numbers["census"]["kernel_calls"] == {"ht_probe": 1,
                                                 "row_gather": 4}
    assert numbers["launches"] == [0, 0, 0]
    assert numbers["child_s"] > numbers["wait_s"] >= 0
    bad = json.loads(json.dumps(got[0]))
    bad["negatives"]["host_wall_clock"] = False
    with pytest.raises(RuntimeError, match="negative proofs"):
        CS.static_phase("cpu", Done(bad))


def test_chip_smoke_runs_the_static_leg_beside_the_durable_phase():
    """main() starts the static leg's child before the durable phase,
    reads its verdict after the clients phase, prints its line before
    the phases' seconds and the kernels line, and every kernel carries
    its launches."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "supervisor_phase(dev)", "StaticChild(dev)", "durable_phase(dev)",
        "clients_phase(dev, rig)", "rig.close()",
        "static_phase(dev, static_child)", "'clients'", "'static'",
        "'phase_seconds'", "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_static':") == 4
    assert CS.ST_CAPTURE_WIDTHS == (4, 8)
    assert " 26. static " in CS.__doc__


def test_gate_phase_rehearsed_on_the_cpu():
    """Phase 27's child process on the CPU at the JAX sizes (the chain leg;
    every leg runs at these sizes in tests/test_torch_gate_legs*.py, the
    op budget's check and lint in tests/test_torch_opbudget.py, and the
    full-width runs only on the card): the leg passes and launches
    nothing on the CPU; the phase passes a green budget and fails a run
    whose kernel calls miss the prediction, one whose launches differ
    from its calls, or a budget that reds."""
    child = CS.GateChild("cpu", legs=("chain",), full={}, budget=False)
    res, child_s = child.finish()
    assert set(res) == {"chain"}
    assert res["chain"]["launches"] == res["chain"]["ran"] == [0, 0]
    assert res["chain"]["numbers"]["clean"]["host_fallbacks"] == 0
    assert res["chain"]["numbers"]["poisoned"]["routes"][
        "chain_batch_fallbacks"]["e2_collision"] >= 1
    green = {"seconds": 0.0, "tiers": 26, "check": [], "lint": [],
             "telemetry": {"lanes": 12}, "launches": [0, 0]}

    class Done:
        def __init__(self, res):
            self.res = res

        def finish(self):
            return self.res, child_s

    numbers = CS.gate_phase("cpu", Done(dict(res, opbudget=green)))
    assert numbers["launches"] == [0, 0]
    assert numbers["child_s"] == child_s > 0
    assert res["chain"]["calls"] == list(CS.gl_calls("chain"))
    bad = json.loads(json.dumps(res))
    bad["chain"]["launches"] = [1, 0]
    with pytest.raises(RuntimeError, match="chain: launches"):
        CS.gate_phase("cpu", Done(dict(bad, opbudget=green)))
    bad = json.loads(json.dumps(res))
    bad["chain"]["calls"] = [42, 176]
    with pytest.raises(RuntimeError, match="predicted"):
        CS.gate_phase("cpu", Done(dict(bad, opbudget=green)))
    with pytest.raises(RuntimeError, match="gate opbudget"):
        CS.gate_phase("cpu", Done(dict(res, opbudget=dict(
            green, check=["plain: heavy_total 47 > budget 46"]))))


def test_chip_smoke_runs_the_gate_legs_beside_the_durable_phase():
    """main() starts the gate legs' child with the static leg's, before the
    durable phase, reads it after the static phase (the read lets the
    overlap leg at the JAX sizes go: it runs while the script waits),
    prints its line before the phases' seconds and the kernels line, and
    the probe and gather kernels carry its launches; the card's
    predictions cover every run but the overload leg's."""
    import ast
    import inspect

    src = inspect.getsource(CS)
    main = ast.unparse(next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "main"))
    order = [main.index(f) for f in (
        "StaticChild(dev)", "GateChild(dev)", "durable_phase(dev)",
        "clients_phase(dev, rig)", "static_phase(dev, static_child)",
        "gate_phase(dev, gate_child)", "'static'", "'gate'",
        "'phase_seconds'", "'kernels'")]
    assert order == sorted(order)
    assert main.count("'launches_gate':") == 2
    assert set(CS.GL_LEGS) | set(CS.GL_FULL) == (
        set(CS.GL_RUNS) | set(CS.GL_PAIRS) | {"overload"})
    assert CS.gl_calls("overload") is None
    assert CS.GL_ALONE == ("overlap",)
    assert " 27. gate " in CS.__doc__


def test_gate_timed_runs_wait_for_the_quiet_host(monkeypatch):
    """With a quiet event, the overlap leg at the JAX sizes comes after
    every other run and the op budget, and starts only once it is set;
    without one, the runs keep their order."""
    import threading

    from tigerbeetle_tpu_torch.testing import (
        chain_smoke, observatory_smoke, overlap_smoke, telemetry_smoke)
    from tigerbeetle_tpu_torch.torchhound import opbudget

    started, timers = [], []

    def stub(name, summary):
        def leg(device, **kw):
            run = name + ("_full" if kw else "")
            started.append((run, quiet.is_set()))
            if run == "chain_full":
                # The last run before the wait: the script reads the
                # child a little later.
                timers.append(threading.Timer(0.2, quiet.set))
                timers[-1].start()
            return summary
        return leg

    pipelined = {"host_fallbacks": 0, "routes": {}}
    overlap = dict(fraction=0.1, sync_fraction=1.0, fallbacks=0, routes={},
                   staging={})
    overhead = {"overhead": {"ratio": 1.0, "ratio_max": 1.05}}
    monkeypatch.setattr(chain_smoke, "chain_smoke", stub(
        "chain", {a: {"pipelined": pipelined}
                  for a in ("clean", "poisoned")}))
    monkeypatch.setattr(overlap_smoke, "overlap_smoke",
                        stub("overlap", overlap))
    monkeypatch.setattr(telemetry_smoke, "telemetry_smoke", stub(
        "telemetry", dict(overhead, census={}, negative_reds=[1])))
    monkeypatch.setattr(observatory_smoke, "observatory_smoke", stub(
        "observatory", dict(overhead, profiler={"routes": [],
                                                 "fractions": {}},
                            memwatch={"leak_reds": 1})))
    monkeypatch.setattr(opbudget, "census_tiers", lambda device, **kw: (
        started.append(("opbudget", quiet.is_set())) or ({}, {})))
    monkeypatch.setattr(opbudget, "telemetry_report",
                        lambda device, traces: {})
    monkeypatch.setattr(opbudget, "check_budgets", lambda cur, **kw: [])
    monkeypatch.setattr(opbudget, "check_telemetry", lambda tel: [])
    monkeypatch.setattr(opbudget, "run_lints", lambda traces: [])
    legs = ("chain", "overlap", "telemetry", "observatory")
    full = {"overlap_full": ("overlap", {"windows": 5}),
            "chain_full": ("chain", {"batch": 8})}
    quiet = threading.Event()
    out = CS.gate_legs_run("cpu", legs, full, budget=True, quiet=quiet)
    assert started == [("chain", False), ("telemetry", False),
                       ("observatory", False), ("overlap_full", False),
                       ("chain_full", False), ("opbudget", False),
                       ("overlap", True)]
    assert out["quiet_wait_s"] > 0
    started.clear()
    out = CS.gate_legs_run("cpu", legs, full, budget=False)
    for t in timers:
        t.join()
    assert [n for n, _ in started] == [
        "chain", "overlap", "telemetry", "observatory", "overlap_full",
        "chain_full"]
    assert "quiet_wait_s" not in out

