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
    assert numbers["routes"] == {"chain": 18}
    assert numbers["counters"][4] == 1           # the hard body
    assert numbers["delta_gathers"] > 0
    assert calls["gather"] >= numbers["delta_gathers"]
    assert all(numbers["query_reply_bytes"].values())
    assert set(numbers["pipelined"]) == {"staged", "staged_ring",
                                         "inline_ring", "inline_ring_2",
                                         "staged_ring_2"}
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
    assert main.count("'launches_serving'") == 3



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
