"""The port's serving supervisor (`tigerbeetle_tpu_torch/serving.py`) and
the ledger's supervisor surface (`MirrorDivergence`, `recovery_stats`,
`fallback_stats`, the tracer hook, the VERIFY drain audit), on the CPU,
against the JAX package's (`tigerbeetle_tpu/serving.py`).

The port's supervisor runs beside the JAX supervisor on the same seeded
traffic: their histories, stats() counters and recovery causes, their
mirrors after every epoch and their ledgers' fallback_stats() keys must
be equal, whatever is injected. The cases follow the JAX package's
`test_chaos.py` (TestRetryPolicy, TestSupervisorRecovery,
TestChaosTracing, TestSpotCheckDiagnostics), `test_verify_mode.py` and
`test_overlap_parity.py` (test_overlap_matches_sync,
test_bitflip_recovery_drains_staged_without_commit). Clean runs must
show zero recoveries: a recovery can mask a port bug.

Most windows hold one prepare of 24 events (the per-batch route: the JAX
package compiles its plain tier at one pad bucket); the pipelined cases
hold two.
"""

import dataclasses
import enum
import random

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import constants as JC
from tigerbeetle_tpu import serving as JS
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu.oracle import StateMachineOracle as JOracle
from tigerbeetle_tpu.ops.batch import transfers_to_arrays as \
    j_transfers_to_arrays
from tigerbeetle_tpu.ops import ledger as JL
from tigerbeetle_tpu.testing import chaos as JCH
from tigerbeetle_tpu.trace import Tracer as JTracer
from tigerbeetle_tpu.trace import FlightRecorder as JFlight
from tigerbeetle_tpu.trace import mint_context as j_mint_context
from tigerbeetle_tpu_torch import constants as TC
from tigerbeetle_tpu_torch import serving as TS
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.ops import ledger as TL
from tigerbeetle_tpu_torch.ops.batch import transfers_to_arrays
from tigerbeetle_tpu_torch.testing import chaos as TCH
from tigerbeetle_tpu_torch.trace import FlightRecorder as TFlight
from tigerbeetle_tpu_torch.trace import Tracer as TTracer
from tigerbeetle_tpu_torch.trace import fmt_trace_id, mint_context
from tests.port_verify import port_verify_restored  # noqa: F401

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

A_CAP = 1 << 8
T_CAP = 1 << 11
RETRY = dict(max_retries=2, base_delay_s=1e-4, max_delay_s=1e-3)


# ------------------------------------------------------------- helpers

def plain(x):
    """A comparable value of a port or JAX object: dataclasses as
    (class name, fields), enums as ints, lazy records built."""
    if hasattr(x, "_build") and not dataclasses.is_dataclass(x):
        x = x._build()
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                tuple(plain(getattr(x, f.name))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return int(x)
    return x


def state_of(sm) -> dict:
    """Everything an oracle state holds, comparable across packages."""
    return dict(
        accounts={k: plain(v) for k, v in sm.accounts.items()},
        transfers={k: plain(v) for k, v in sm.transfers.items()},
        pending_status={k: int(v) for k, v in sm.pending_status.items()},
        expiry=dict(sm.expiry), orphaned=set(sm.orphaned),
        account_events=[plain(r) for r in sm.account_events],
        pulse_next=sm.pulse_next_timestamp,
        key_max=(sm.accounts_key_max, sm.transfers_key_max),
        commit_ts=sm.commit_timestamp)


def port(obj):
    """A JAX Account / Transfer as the port's."""
    return getattr(TT, type(obj).__name__)(**dataclasses.asdict(obj))


def counters(sup) -> dict:
    """A supervisor's stats() without the host-clock and path fields."""
    st = sup.stats()
    st.pop("flight")
    led = st.pop("ledger")
    return dict(st, ledger_keys=sorted(led),
                ledger=dict(led, staging=None))


def _simple_window(next_id, ts, n=24, k=1):
    """k prepares of n uniform transfers over accounts 1..8 (JAX objects),
    the JAX test_chaos.py workload."""
    rng = random.Random(next_id)
    batches, tss = [], []
    for b in range(k):
        evs = []
        for i in range(n):
            dr = rng.randrange(1, 9)
            evs.append(JT.Transfer(
                id=next_id + b * n + i, debit_account_id=dr,
                credit_account_id=dr % 8 + 1,
                amount=rng.randrange(1, 50), ledger=1, code=1))
        batches.append(evs)
        tss.append(ts + b * (n + 10))
    return batches, tss


class Pair:
    """A JAX supervisor and the port's (its ledger on the CPU), built
    alike and fed the same script; `check` holds them equal."""

    def __init__(self, epoch_interval=2, seed=0, hooks=(None, None),
                 tracers=(None, None), flights=(None, None), **kw):
        common = dict(epoch_interval=epoch_interval, seed=seed,
                      sleep=lambda s: None, **kw)
        self.j = JS.ServingSupervisor(
            A_CAP, T_CAP, retry=JS.RetryPolicy(**RETRY),
            fault_hook=hooks[0], tracer=tracers[0],
            flight_recorder=flights[0], **common)
        self.t = TS.ServingSupervisor(
            A_CAP, T_CAP, retry=TS.RetryPolicy(**RETRY),
            fault_hook=hooks[1], tracer=tracers[1],
            flight_recorder=flights[1], device="cpu", **common)
        self.script = []
        self.accounts([JT.Account(id=i, ledger=1, code=1)
                       for i in range(1, 9)], 1_000)

    def accounts(self, accts, ts):
        self.j.create_accounts(accts, ts)
        self.t.create_accounts([port(a) for a in accts], ts)
        self.script.append(("accounts", accts, ts))

    def window(self, batches, tss, ctxs=None, pipelined=False):
        t_batches = [[port(e) for e in b] for b in batches]
        if pipelined:
            self.j.submit_transfers_window(batches, tss)
            self.t.submit_transfers_window(t_batches, tss)
        else:
            self.j.create_transfers_window(batches, tss,
                                           trace_ctxs=ctxs and ctxs[0])
            self.t.create_transfers_window(t_batches, tss,
                                           trace_ctxs=ctxs and ctxs[1])
        self.script.append(("window", batches, tss))

    def check(self):
        """History, counters and recovery causes equal; after an epoch
        the mirrors equal each other and the oracle."""
        assert self.t.history == self.j.history
        assert counters(self.t) == counters(self.j)
        assert self.t.last_recovery == self.j.last_recovery
        if not self.t.log:
            assert state_of(self.t.epoch_base) == state_of(self.j.epoch_base)
            assert state_of(self.t.led.mirror) == state_of(self.j.led.mirror)

    def audit(self):
        """The JAX test_chaos.py audit, on the port: its history equals a
        clean oracle replay of the script, its device state (read back)
        the oracle's."""
        self.check()
        expected, audit = TCH.oracle_history(
            [(k, [[port(e) for e in b] for b in p] if k == "window"
              else [port(a) for a in p], w) for k, p, w in self.script])
        assert self.t.history == expected
        host = self.t.led.to_host()
        for field in TCH.AUDITED_FIELDS:
            assert getattr(host, field) == getattr(audit, field), field

    def close(self):
        self.j.led.shutdown_staging()
        self.t.led.shutdown_staging()


def _run(pair, windows, corrupt_at=None, ctx_of=None, k=1,
         pipelined=False):
    """The JAX TestSupervisorRecovery loop on both supervisors: windows
    of k prepares, an in-place bit flip of a live account balance before
    window `corrupt_at`, a final verify_epoch; checked after every
    window."""
    ts = 10 ** 9
    next_id = 1_000
    for w in range(windows):
        if corrupt_at is not None and w == corrupt_at:
            for led, inject in ((pair.j.led, JCH.inject_state_bitflip),
                                (pair.t.led, TCH.inject_state_bitflip)):
                f = {"target": "accounts_bal", "row_pick": 3,
                     "col_pick": 5, "bit": 11}
                assert inject(led, f), f
        ts += 40 * k
        batches, tss = _simple_window(next_id, ts, k=k)
        next_id += 24 * k
        ctxs = ctx_of(w) if ctx_of else None
        pair.window(batches, tss, ctxs, pipelined=pipelined)
        if not pipelined:
            pair.check()
    pair.j.verify_epoch()
    pair.t.verify_epoch()
    pair.check()


@pytest.fixture
def verify_on():
    was_t, was_j = TC.VERIFY, JC.VERIFY
    TC.set_verify(True)
    JC.set_verify(True)
    yield
    TC.set_verify(was_t)
    JC.set_verify(was_j)


# ------------------------------------------------------ retry policy

def _both_retries(fn_of, seed=0, **policy):
    """call_with_retries on both packages with the same failing thunk:
    (result or exception cause, counters, sleeps) each."""
    out = []
    for mod in (TS, JS):
        sleeps = []
        ctr = (TL if mod is TS else JL).default_recovery_stats()
        try:
            res = mod.call_with_retries(fn_of(mod), mod.RetryPolicy(**policy),
                                        random.Random(seed), ctr,
                                        sleep=sleeps.append)
        except mod.RecoveryNeeded as e:
            res = e.cause
        out.append((res, ctr, sleeps))
    return out


class TestRetryPolicy:
    def test_transient_faults_retry_then_succeed(self):
        def fn_of(mod):
            calls = {"n": 0}

            def fn():
                calls["n"] += 1
                if calls["n"] <= 2:
                    raise mod.TransientDispatchError("flaky")
                return "ok"
            return fn

        t, j = _both_retries(fn_of, max_retries=3)
        assert t == j
        res, ctr, sleeps = t
        assert res == "ok" and ctr["retries"] == 2 and len(sleeps) == 2
        assert sleeps[1] > sleeps[0]
        assert ctr["backoff_s"] == pytest.approx(sum(sleeps), abs=1e-5)

    @pytest.mark.parametrize("seed", (1, 2))
    def test_backoff_jitter_is_seeded(self, seed):
        def fn_of(mod):
            calls = {"n": 0}

            def fn():
                calls["n"] += 1
                if calls["n"] <= 3:
                    raise mod.TransientDispatchError("flaky")
            return fn

        t, j = _both_retries(fn_of, seed=seed, max_retries=3)
        assert t == j
        assert t[2] != _both_retries(fn_of, seed=seed + 10,
                                     max_retries=3)[0][2]

    @pytest.mark.parametrize("exc, cause", [
        ("DispatchTimeout", "dispatch_exhausted"),
        ("MirrorDivergence", "mirror_divergence"),
        ("KeyError", "drain_fault"), ("IndexError", "drain_fault"),
        ("ValueError", "drain_fault")])
    def test_escalations_to_recovery(self, exc, cause):
        def fn_of(mod):
            cls = {"DispatchTimeout": mod.DispatchTimeout,
                   "MirrorDivergence": (TL if mod is TS
                                        else JL).MirrorDivergence,
                   "KeyError": KeyError, "IndexError": IndexError,
                   "ValueError": ValueError}[exc]

            def fn():
                raise cls("injected")
            return fn

        t, j = _both_retries(fn_of, max_retries=2)
        assert t == j
        assert t[0] == cause
        assert t[1]["retries"] == (3 if exc == "DispatchTimeout" else 0)

    def test_deadline_escalates_to_recovery(self):
        clock = {"t": 0.0}

        def fn():
            clock["t"] += 100.0
            raise TS.TransientDispatchError("slow")

        with pytest.raises(TS.RecoveryNeeded) as ei:
            TS.call_with_retries(fn, TS.RetryPolicy(max_retries=99,
                                                    deadline_s=50.0),
                                 random.Random(0),
                                 TL.default_recovery_stats(),
                                 sleep=lambda s: None,
                                 clock=lambda: clock["t"])
        assert ei.value.cause == "dispatch_deadline"

    def test_clamped_deadline_bounds_total_retry_budget(self):
        t = {"t": 0.0}

        def fn():
            t["t"] += 0.010
            raise TS.TransientDispatchError("saturated")

        policy = TS.RetryPolicy(max_retries=99, base_delay_s=0.050,
                                max_delay_s=10.0, deadline_s=30.0,
                                jitter=0.0).clamped(0.080)
        assert policy.deadline_s == pytest.approx(0.080)
        with pytest.raises(TS.RecoveryNeeded) as ei:
            TS.call_with_retries(fn, policy, random.Random(0),
                                 TL.default_recovery_stats(),
                                 sleep=lambda s: t.__setitem__(
                                     "t", t["t"] + s),
                                 clock=lambda: t["t"])
        assert ei.value.cause == "dispatch_deadline"
        assert t["t"] <= 0.080 + 0.010 + 1e-9

    def test_clamped_tightens_never_loosens(self):
        p = TS.RetryPolicy(deadline_s=0.5)
        assert p.clamped(30.0) is p
        assert p.clamped(None) is p
        assert p.clamped(0.1).deadline_s == pytest.approx(0.1)
        assert p.clamped(-1.0).deadline_s == 0.0
        assert dataclasses.asdict(p) == dataclasses.asdict(
            JS.RetryPolicy(deadline_s=0.5))

    def test_a_device_error_propagates_untouched(self):
        """A CUDA error (a RuntimeError, not a TransientDispatchError) is
        never retried and never escalated to a recovery."""
        ctr = TL.default_recovery_stats()

        def fn():
            raise RuntimeError("CUDA error: an illegal memory access")

        with pytest.raises(RuntimeError, match="illegal memory access"):
            TS.call_with_retries(fn, TS.RetryPolicy(), random.Random(0),
                                 ctr, sleep=lambda s: None)
        assert ctr == TL.default_recovery_stats()


# ------------------------------------------------ supervisor, both sides

class TestSupervisorRecovery:
    def test_clean_run_verifies_epochs_and_never_recovers(self):
        pair = Pair()
        _run(pair, windows=4)
        pair.audit()
        st = pair.t.stats()
        assert st["epochs_verified"] >= 2
        assert st["recoveries"] == {} and st["checksum_mismatches"] == 0
        assert st["replayed_windows"] == 0
        assert sorted(pair.t.epoch_ms) == sorted(
            ("drain", "replay", "device_digest", "oracle_digest",
             "mirror_audit"))
        pair.close()

    def test_bitflip_in_place_detected_and_recovered_to_parity(self):
        pair = Pair(epoch_interval=2)
        led = pair.t.led
        bal = led.state["accounts"]["bal"]
        ptr, before = bal.data_ptr(), bal.clone()
        f = {"target": "accounts_bal", "row_pick": 3, "col_pick": 5,
             "bit": 11}
        assert TCH.inject_state_bitflip(led, f)
        # In place: the same tensor, the same storage, one bit flipped.
        assert led.state["accounts"]["bal"] is bal and bal.data_ptr() == ptr
        diff = (bal ^ before).nonzero().tolist()
        assert diff == [[3, 5]] and int((bal ^ before)[3, 5]) == 1 << 11
        assert f["where"] == "accounts_bal[3,5] bit 11"
        JCH.inject_state_bitflip(pair.j.led, dict(f))
        _run(pair, windows=4)
        pair.audit()
        recs = pair.t.counters["recoveries"]
        assert recs == {"state_digest": 1}
        assert pair.t.counters["checksum_mismatches"] == 1
        assert pair.t.led is not led and led.state is None  # released
        pair.close()

    def test_bitflip_detected_mid_run(self):
        pair = Pair(epoch_interval=2)
        _run(pair, windows=4, corrupt_at=1)
        pair.audit()
        assert sum(pair.t.counters["recoveries"].values()) >= 1
        pair.close()

    def test_replay_is_bounded_by_epoch_interval(self):
        pair = Pair(epoch_interval=3)
        _run(pair, windows=6, corrupt_at=1)
        pair.audit()
        assert pair.t.last_recovery["replayed_windows"] <= 3
        assert pair.t.counters["replayed_windows"] <= 3
        pair.close()

    @pytest.mark.parametrize("n_fail, exc", [
        (2, "TransientDispatchError"), (5, "DispatchTimeout")])
    def test_dispatch_faults(self, n_fail, exc):
        """Within the retry budget: retries only; past it: a recovery
        (dispatch_exhausted) and a re-dispatch on the rebuilt ledger."""
        def hook_of(mod):
            fails = {"left": n_fail}

            def hook(win, what):
                if what == "window" and fails["left"]:
                    fails["left"] -= 1
                    raise getattr(mod, exc)("injected")
            return hook

        pair = Pair(hooks=(hook_of(JS), hook_of(TS)))
        _run(pair, windows=3)
        pair.audit()
        recs = pair.t.counters["recoveries"]
        if n_fail <= RETRY["max_retries"]:
            assert pair.t.counters["retries"] == n_fail and recs == {}
        else:
            assert recs.get("dispatch_exhausted", 0) >= 1
        pair.close()

    def test_recovery_counters_surface_through_fallback_stats(self):
        pair = Pair(epoch_interval=2)
        _run(pair, windows=4, corrupt_at=1)
        rec = pair.t.led.fallback_stats()["recovery"]
        assert rec["replayed_windows"] == \
            pair.t.counters["replayed_windows"] > 0
        assert rec["recoveries"] == pair.t.counters["recoveries"]
        assert (sorted(pair.t.led.fallback_stats())
                == sorted(pair.j.led.fallback_stats()))
        assert pair.t.led.fallback_stats()["device_telemetry"] is None
        pair.close()

    def test_a_device_error_propagates_out_of_the_supervisor(self):
        def hook(win, what):
            raise RuntimeError("CUDA error: launch failed")

        sup = TS.ServingSupervisor(A_CAP, T_CAP, device="cpu",
                                   sleep=lambda s: None)
        sup.create_accounts([TT.Account(id=1, ledger=1, code=1),
                             TT.Account(id=2, ledger=1, code=1)], 1_000)
        sup.fault_hook = hook
        batches, tss = _simple_window(1_000, 10**9)
        with pytest.raises(RuntimeError, match="launch failed"):
            sup.create_transfers_window([[port(e) for e in batches[0]]], tss)
        assert sup.counters["recoveries"] == {}
        assert sup.counters["retries"] == 0


def test_supervisor_device_none_means_cuda(monkeypatch):
    """ServingSupervisor(device=None) runs on the card and raises without
    one; the ledger a recovery rebuilds goes on the same device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.ServingSupervisor(A_CAP, T_CAP)
    sup = TS.ServingSupervisor(A_CAP, T_CAP, device="cpu",
                               sleep=lambda s: None)
    assert sup.device.type == "cpu" and sup.led.device.type == "cpu"
    sup._recover("state_digest")
    assert sup.led.device.type == "cpu"


def test_spot_rate_survives_a_recovery():
    sup = TS.ServingSupervisor(A_CAP, T_CAP, device="cpu",
                               sleep=lambda s: None)
    assert sup.led.verify_spot_rate == 0.0
    sup.led.verify_spot_rate = 1.0
    sup._recover("drain_fault")
    assert sup.led.verify_spot_rate == 1.0
    assert sup.recovery_ms[-1]["cause"] == "drain_fault"


# ------------------------------------------- pipelined windows, both sides

def _overlap_windows(seed, n_windows, k=3, n=64, base=10**6,
                     with_pend=False, poison_window=None):
    """test_overlap_parity.py's windows (JAX objects): k batches of n over
    64 accounts, pendings and their posts, a repeated id (a hard
    fallback) in window `poison_window`."""
    rng = np.random.default_rng(seed)
    out, nid, ts, pend_pool = [], base, 10**12, []
    for w in range(n_windows):
        evs, tss = [], []
        for b in range(k):
            batch = []
            for i in range(n):
                dr = int(rng.integers(1, 65))
                if with_pend and pend_pool and i % 5 == 0:
                    batch.append(JT.Transfer(
                        id=nid, pending_id=pend_pool.pop(0),
                        amount=(1 << 128) - 1, ledger=1, code=1,
                        flags=int(JT.TransferFlags.post_pending_transfer)))
                else:
                    f = (int(JT.TransferFlags.pending)
                         if (with_pend and i % 4 == 0) else 0)
                    batch.append(JT.Transfer(
                        id=nid, debit_account_id=dr,
                        credit_account_id=dr % 64 + 1,
                        amount=int(rng.integers(1, 100)), ledger=1,
                        code=1, flags=f, timeout=10 if f else 0))
                    if f:
                        pend_pool.append(nid)
                nid += 1
            if poison_window == w and b == k // 2:
                batch[-1] = JT.Transfer(id=batch[0].id, debit_account_id=1,
                                        credit_account_id=2, amount=1,
                                        ledger=1, code=1)
            ts += n + 10
            evs.append(batch)
            tss.append(ts)
        out.append((evs, tss))
    return out


@pytest.mark.parametrize("with_pend, poison", [(False, None), (True, 2)])
def test_overlap_matches_sync(with_pend, poison):
    """The port's ledger, windows staged ahead and submitted two deep,
    against the same windows synchronously: equal results, equal state,
    and the results of the JAX oracle; stages consumed on identity."""
    windows = _overlap_windows(3, 4, with_pend=with_pend,
                               poison_window=poison)
    leds = []
    for overlap in (True, False):
        led = TL.DeviceLedger(a_cap=1 << 10, t_cap=1 << 13, device="cpu")
        led.create_accounts([TT.Account(id=i, ledger=1, code=1)
                             for i in range(1, 65)], 120)
        led.overlap_staging = overlap
        leds.append(led)
    led_p, led_s = leds
    arrs = [[transfers_to_arrays([port(e) for e in b]) for b in evs]
            for evs, _ in windows]
    results_p, pending = [], []
    for i, (_evs, tss) in enumerate(windows):
        tk = led_p.submit_window(arrs[i], tss)
        if tk is None:
            led_p.resolve_windows()
            results_p.extend(p.results[1] for p in pending)
            pending = []
            results_p.append(led_p.create_transfers_window(arrs[i], tss))
            continue
        pending.append(tk)
        if i + 1 < len(windows):
            led_p.stage_window(arrs[i + 1], windows[i + 1][1])
        if len(pending) >= 2:
            led_p.resolve_windows(count=1)
            while pending and pending[0].results is not None:
                results_p.append(pending.pop(0).results[1])
    led_p.resolve_windows()
    results_p.extend(p.results[1] for p in pending)
    led_p.shutdown_staging()
    results_s = [led_s.create_transfers_window(
        [transfers_to_arrays([port(e) for e in b]) for b in evs], tss)
        for evs, tss in windows]
    orc = JOracle()
    orc.create_accounts([JT.Account(id=i, ledger=1, code=1)
                         for i in range(1, 65)], 120)
    for (evs, tss), got_p, got_s in zip(windows, results_p, results_s):
        for b, t, (st_p, ts_p), (st_s, ts_s) in zip(evs, tss, got_p, got_s):
            want = orc.create_transfers(b, t)
            assert st_p.tolist() == st_s.tolist() == [int(r.status)
                                                      for r in want]
            assert ts_p.tolist() == ts_s.tolist() == [r.timestamp
                                                      for r in want]
    assert state_of(led_p.to_host()) == state_of(led_s.to_host()) \
        == state_of(orc)
    st = led_p.staging_stats
    assert st["staged"] >= 1
    assert st["staged"] + st["misses"] == st["windows"] - 1 \
        or poison is not None, st


@pytest.mark.parametrize("faulted", (True, False))
def test_bitflip_recovery_drains_staged_without_commit(faulted):
    """A bit flip mid-pipeline: the epoch check catches it, recovery
    replays the logged windows (in-flight windows adopt the replay's
    answers), and a window staged but never dispatched dies with the
    quarantined ledger: its transfers never commit, and serving goes on
    on the rebuilt ledger. Both packages' supervisors, side by side."""
    windows = _overlap_windows(41, 4, k=2, n=32, base=4 * 10**6)
    accts = [JT.Account(id=i, ledger=1, code=1) for i in range(1, 65)]
    sups = []
    for mod, chaos, cpu in ((JS, JCH, {}), (TS, TCH, {"device": "cpu"})):
        conv = (lambda x: x) if mod is JS else port
        sup = mod.ServingSupervisor(a_cap=1 << 10, t_cap=1 << 13,
                                    epoch_interval=100, **cpu)
        sup.create_accounts([conv(a) for a in accts], 120)
        for batches, tss in windows[:3]:
            sup.submit_transfers_window([[conv(e) for e in b]
                                         for b in batches], tss)
        staged_batches, staged_tss = windows[3]
        staged = [[conv(e) for e in b] for b in staged_batches]
        if faulted:
            f = {"target": "transfers_u64", "row_pick": 0, "col_pick": 0,
                 "bit": 7}
            assert chaos.inject_state_bitflip(sup.led, f), f
            evs = [(transfers_to_arrays if mod is TS
                    else j_transfers_to_arrays)(b) for b in staged]
            assert sup.led.stage_window(evs, staged_tss)
            old_led = sup.led
            assert not sup.verify_epoch()
            assert sup.last_recovery["cause"] == "state_digest"
            assert sup.counters["checksum_mismatches"] >= 1
            assert sup.led is not old_led
            assert old_led._staged is None and old_led._stager is None
            assert sup.led._staged is None
            for b in staged_batches:
                for ev in b:
                    assert ev.id not in sup.led.mirror.transfers
                    assert ev.id not in sup.epoch_base.transfers
        else:
            assert sup.verify_epoch()
            assert not sup.counters["recoveries"]
        sup.submit_transfers_window(staged, staged_tss)
        sup.drain_pipeline()
        assert sup.verify_epoch()
        sup.led.shutdown_staging()
        sups.append(sup)
    j, t = sups
    assert t.history == j.history
    assert counters(t) == counters(j)
    assert state_of(t.epoch_base) == state_of(j.epoch_base)
    assert state_of(t.led.mirror) == state_of(j.led.mirror)


# ----------------------------------------------- chaos x causal tracing

class TestChaosTracing:
    """Chaos and tracing compose: a fault mid-request leaves the
    affected requests' traces tail-kept (reason = the recovery cause) and
    cross-referenced from the flight artifact by trace id — equal on both
    packages."""

    def _pair(self, tmp_path):
        tracers = (JTracer(pid=0), TTracer(pid=0))
        flights = (JFlight(tracer=tracers[0], out_dir=str(tmp_path / "j")),
                   TFlight(tracer=tracers[1], dump_dir=str(tmp_path / "t")))
        return Pair(tracers=tracers, flights=flights), tracers, flights

    @staticmethod
    def _ctx_of(w):
        return ([j_mint_context(3, w + 1, head_rate=1.0)],
                [mint_context(3, w + 1, head_rate=1.0)])

    def test_recovery_tail_keeps_affected_traces(self, tmp_path):
        pair, (jt, tt), _ = self._pair(tmp_path)
        _run(pair, windows=4, corrupt_at=1, ctx_of=self._ctx_of)
        trace_ids = {fmt_trace_id(self._ctx_of(w)[1][0].trace_id)
                     for w in range(4)}
        recs = pair.t.counters["recoveries"]
        assert sum(recs.values()) >= 1
        assert tt.kept_traces == jt.kept_traces
        assert tt.kept_traces and set(tt.kept_traces.values()) <= set(recs)
        assert set(tt.kept_traces) <= trace_ids
        assert tt.counters == jt.counters
        assert tt.counters["trace_tail_keep"] == len(tt.kept_traces)
        before = dict(tt.kept_traces)
        _run(pair, windows=2, ctx_of=self._ctx_of)
        assert tt.kept_traces == before
        pair.close()

    def test_flight_artifact_names_affected_trace_ids(self, tmp_path):
        import json

        pair, (jt, tt), (jf, tf) = self._pair(tmp_path)
        _run(pair, windows=4, corrupt_at=1, ctx_of=self._ctx_of)
        assert tf.dumps == jf.dumps >= 1
        with open(tf.last_dump_path) as f, open(jf.last_dump_path) as g:
            doc, jdoc = json.load(f), json.load(g)
        assert doc == jdoc
        assert tf.last_dump_path.startswith(str(tmp_path / "t"))
        recovery = [r for r in doc["records"] if r.get("route") == "recovery"]
        assert recovery
        assert set(recovery[-1]["detail"]["trace_ids"]) == set(tt.kept_traces)
        pair.close()

    def test_window_spans_link_constituent_traces(self, tmp_path):
        pair, (jt, tt), _ = self._pair(tmp_path)
        _run(pair, windows=2, ctx_of=self._ctx_of)

        def links(tr):
            out = set()
            for e in tr.events:
                if e.get("name") == "window_commit":
                    out.update((e.get("args") or {}).get("links") or ())
            return out

        assert links(tt) == links(jt) == {
            fmt_trace_id(self._ctx_of(w)[1][0].trace_id) for w in range(2)}
        assert ({e["name"] for e in tt.events}
                == {e["name"] for e in jt.events})
        pair.close()


# ---------------------------------------------------- the VERIFY audit

def _device_sm(mod_sm, types, n=50, **kw):
    sm = mod_sm.StateMachine(engine="device", a_cap=1 << 12, t_cap=1 << 14,
                             **kw)
    sm.create_accounts([types.Account(id=i, ledger=1, code=1)
                        for i in range(1, 11)], 100)
    evs = [types.Transfer(id=1000 + i, debit_account_id=1 + i % 9,
                          credit_account_id=2 + i % 8, amount=1, ledger=1,
                          code=1) for i in range(n)]
    for e in evs:
        if e.debit_account_id == e.credit_account_id:
            e.credit_account_id = e.debit_account_id % 10 + 1
    sm.create_transfers(evs, 10_000)
    return sm


def _port_sm(**kw):
    from tigerbeetle_tpu_torch import state_machine
    return _device_sm(state_machine, TT, device="cpu", **kw)


def _jax_sm(**kw):
    from tigerbeetle_tpu import state_machine
    return _device_sm(state_machine, JT, **kw)


class TestSpotCheckDiagnostics:
    @pytest.mark.parametrize("rate", (0.0, 1.0))
    def test_divergence_names_op_and_fields(self, verify_on, monkeypatch,
                                            rate):
        """A mirror object corrupted after a clean drain: the next drain's
        audit raises MirrorDivergence naming the op that produced the
        chunk, the device rows and every differing field with both
        values — the JAX package's message, word for word."""
        monkeypatch.setenv("TB_VERIFY_SPOT_RATE", str(rate))
        msgs = []
        for sm, types in ((_port_sm(), TT), (_jax_sm(), JT)):
            if types is TT:
                sm.led.verify_spot_rate = rate
            _ = sm.state.transfers  # clean drain
            tid = next(iter(sm.state.transfers))
            sm.state.transfers[tid] = dataclasses.replace(
                sm.state.transfers[tid], amount=424242)
            sm.create_transfers(
                [types.Transfer(id=900, debit_account_id=1,
                                credit_account_id=2, amount=1, ledger=1,
                                code=1)], 20_000)
            with pytest.raises(AssertionError) as ei:
                _ = sm.state.transfers
            assert type(ei.value).__name__ == "MirrorDivergence"
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
        msg = msgs[0]
        assert "device/mirror divergence" in msg and "op " in msg
        assert "device rows" in msg
        assert "amount" in msg and "424242" in msg

    def test_poisoned_chunk_caught_by_the_spot_audit(self, verify_on):
        """poison_delta_fetch lands in the chunk's own loaded columns;
        the drain's audit at rate 1.0 names the op and the field."""
        sm = _port_sm()
        sm.led.verify_spot_rate = 1.0
        _ = sm.state.transfers
        sm.create_transfers(
            [TT.Transfer(id=2000 + i, debit_account_id=1,
                         credit_account_id=2, amount=5, ledger=1, code=1)
             for i in range(8)], 30_000)
        f = {"key": "amt_lo", "row_pick": 3, "bit": 4}
        assert TCH.poison_delta_fetch(sm.led, f)
        assert f["where"].endswith("amt_lo[3]")
        with pytest.raises(TL.MirrorDivergence) as ei:
            _ = sm.state.transfers
        msg = str(ei.value)
        assert "transfer 2003" in msg and "op " in msg
        assert "amount(device=5, mirror=21)" in msg


def test_mirror_spot_audit_passes_clean(verify_on):
    sm = _port_sm()
    _ = sm.state.transfers
    assert sm.led.fallbacks == 0


def test_mirror_spot_audit_fires_on_divergence(verify_on):
    """The oldest mirror transfer corrupted (a row no later batch
    rewrites): the stable-anchor audit catches it."""
    sm = _port_sm()
    _ = sm.state.transfers
    tid = next(iter(sm.state.transfers))
    sm.state.transfers[tid] = dataclasses.replace(
        sm.state.transfers[tid], amount=999_999)
    sm.create_transfers([TT.Transfer(id=5000 + i, debit_account_id=1,
                                     credit_account_id=2, amount=1,
                                     ledger=1, code=1) for i in range(4)],
                        20_000)
    with pytest.raises(AssertionError, match="device/mirror divergence"):
        _ = sm.state.transfers


def test_verify_off_skips_checks():
    TC.set_verify(False)
    sm = _port_sm()
    sm.state.accounts[1] = dataclasses.replace(
        sm.state.accounts[1], debits_posted=12345)
    sm.create_transfers([TT.Transfer(id=7000, debit_account_id=2,
                                     credit_account_id=3, amount=1,
                                     ledger=1, code=1)], 30_000)
    _ = sm.state.transfers  # no audit, no raise


def test_tracer_hook_records_window_stages():
    """The ledger's tracer receives the pipelined route's window_stage
    spans (inline and overlapped) and the host_stall_fraction gauge."""
    sup = TS.ServingSupervisor(1 << 10, 1 << 13, device="cpu",
                               tracer=TTracer(pid=0), epoch_interval=100)
    sup.create_accounts([TT.Account(id=i, ledger=1, code=1)
                         for i in range(1, 65)], 120)
    for evs, tss in _overlap_windows(5, 3, k=2, n=16):
        sup.submit_transfers_window([[port(e) for e in b] for b in evs],
                                    tss)
    sup.drain_pipeline()
    tr = sup.tracer
    modes = [e["args"]["mode"] for e in tr.events
             if e["name"] == "window_stage"]
    assert modes and set(modes) <= {"inline", "overlapped"}
    assert "host_stall_fraction" in tr.gauges
    assert sup.led.staging_summary()["windows"] == 3
    assert sup.verify_epoch() and sup.counters["recoveries"] == {}
    sup.led.shutdown_staging()


def test_observatory_hooks_are_driven():
    """The profiler, memwatch and alert-engine hooks (None by default)
    are called where the JAX supervisor calls them: the profiler around
    each synchronous window dispatch with its late route and tier and
    the ledger's device (a sample waits for it), the
    memwatch at each verified epoch, the alert engine once a committed
    window; stats() carries their records."""
    calls = []

    class Profiler:
        def time(self, thunk, route, tier, device):
            out = thunk()
            calls.append(("profile", route(), tier(), device.type))
            return out

        def stats(self):
            return {"sampled": 1}

    class MemWatch:
        def observe(self, led):
            calls.append(("memwatch", led.device.type))

        def stats(self):
            return {"observed": 1}

    class Alerts:
        def bind(self, tracer, flight):
            calls.append(("bind",))

        def tick(self):
            calls.append(("tick",))

        def stats(self):
            return {"fired": 0}

    sup = TS.ServingSupervisor(A_CAP, T_CAP, device="cpu",
                               epoch_interval=1, sleep=lambda s: None,
                               profiler=Profiler(), memwatch=MemWatch(),
                               alert_engine=Alerts())
    sup.create_accounts([TT.Account(id=i, ledger=1, code=1)
                         for i in range(1, 9)], 1_000)
    batches, tss = _simple_window(1_000, 10**9)
    sup.create_transfers_window([[port(e) for e in batches[0]]], tss)
    assert calls == [("bind",), ("profile", "per_batch", "fallback", "cpu"),
                     ("tick",), ("memwatch", "cpu")]
    assert sup.stats()["observatory"] == {
        "profiler": {"sampled": 1}, "memwatch": {"observed": 1},
        "alerts": {"fired": 0}}
