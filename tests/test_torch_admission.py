"""The port's admission plane (`tigerbeetle_tpu_torch/admission.py`) against
the JAX package's (`tigerbeetle_tpu/admission.py`), on the CPU.

Each case drives both planes — each in front of its own package's
ServingSupervisor, on its own VirtualClock — with the same calls: the
same sessions, requests, pumps, clock advances and forced shed levels.
After every step the requests must stand alike (state, shed reason,
queue wait, history index) and at the end the planes' stats(), shed
results and conservation, and the supervisors' histories, must be equal;
the history must equal an oracle replay of exactly the admitted script.
The cases are the JAX package's `test_admission.py` and the admission
cases of `test_overlap_parity.py`.

One signal of the shed line reads the host clock: the ledger's measured
host_stall_fraction (pack wait over pack work), which no two runs, let
alone two implementations, share. The planes here run with
stall_shed_fraction=1.0 (a fraction never exceeds it), and
test_stall_signal_raises_the_line drives that signal on both packages
through the ledger's staging counters instead.
"""

import dataclasses

import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import admission as JA
from tigerbeetle_tpu import serving as JS
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu_torch import admission as TA
from tigerbeetle_tpu_torch import serving as TS
from tigerbeetle_tpu_torch import types as TT

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

CLASSES = (("critical", 0, 50.0, 200.0), ("standard", 1, 100.0, 400.0),
           ("batch", 2, 150.0, 600.0))
TWO_CLASSES = (("critical", 0, 100.0, 400.0), ("batch", 1, 200.0, 800.0))


class Planes:
    """The same plane on both packages: a = the port's, b = the JAX
    package's."""

    def __init__(self, classes=CLASSES, seed=3, **kw):
        self.sides = []
        for mod_a, mod_s, types, dev in ((TA, TS, TT, {"device": "cpu"}),
                                         (JA, JS, JT, {})):
            clock = mod_a.VirtualClock()
            sup = mod_s.ServingSupervisor(a_cap=1 << 8, t_cap=1 << 11,
                                          epoch_interval=4,
                                          sleep=lambda s: None, seed=seed,
                                          **dev)
            args = dict(classes=tuple(mod_a.AdmissionClass(*c)
                                      for c in classes),
                        prepare_max=16, window_prepares=2,
                        session_credits=2, max_queue=32,
                        burn_window_ticks=4, burn_budget=0.25, cool_ticks=2,
                        stall_shed_fraction=1.0, clock=clock, seed=seed)
            args.update(kw)
            plane = mod_a.AdmissionPlane(sup, **args)
            plane.open_accounts([types.Account(id=i, ledger=1, code=1)
                                 for i in (1, 2)], 1_000)
            self.sides.append((plane, sup, clock, types))

    @property
    def port(self):
        return self.sides[0][0]

    def submit(self, sid, n, start, cls="standard"):
        reqs = []
        for plane, _, _, types in self.sides:
            evs = [types.Transfer(id=start + i, debit_account_id=1,
                                  credit_account_id=2, amount=1, ledger=1,
                                  code=1) for i in range(n)]
            reqs.append(plane.submit(sid, evs, cls=cls))
        assert _req(reqs[0]) == _req(reqs[1])
        return reqs[0]

    def pump(self, **kw):
        n = [plane.pump(**kw) for plane, *_ in self.sides]
        assert n[0] == n[1]
        self.same()
        return n[0]

    def advance(self, ds):
        for _, _, clock, _ in self.sides:
            clock.advance(ds)

    def force(self, level):
        for plane, *_ in self.sides:
            plane.force_shed_level(level)
        self.same()

    def drain(self, **kw):
        for plane, *_ in self.sides:
            plane.drain(**kw)
        self.same()

    def same(self):
        (a, sa, _, _), (b, sb, _, _) = self.sides
        assert a.stats() == b.stats()
        assert a.shed_level == b.shed_level
        assert ([dataclasses.asdict(r) for r in a.shed_results]
                == [dataclasses.asdict(r) for r in b.shed_results])
        assert a.conservation() == b.conservation()
        assert sa.history == sb.history

    def check_oracle(self):
        """Bit-exact under shedding: each supervisor's history equals an
        oracle replay of exactly its plane's admitted script, and the
        epoch verifies."""
        for plane, sup, _, _ in self.sides:
            hist, _ = plane.oracle_history()
            assert hist == sup.history
            assert sup.verify_epoch()
            assert sup.counters["recoveries"] == {}

    def close(self):
        for _, sup, _, _ in self.sides:
            sup.led.shutdown_staging()


def _req(r):
    return (r.state, r.shed and dataclasses.asdict(r.shed), r.admit_wait_ms,
            r.hist_idx, r.request_id, r.trace_id, r.cls.name)


class TestBackpressure:
    def test_no_credit_fast_reject_and_credit_return(self):
        p = Planes(session_credits=2)
        r1 = p.submit(7, 2, 100)
        r2 = p.submit(7, 2, 200)
        r3 = p.submit(7, 2, 300)
        assert r1.state == r2.state == "queued"
        assert r3.state == "shed" and r3.shed.reason == "no_credit"
        assert r3.shed.session_id == 7 and r3.shed.cls == "standard"
        p.pump()
        assert r1.state == r2.state == "admitted"
        assert p.submit(7, 2, 400).state == "queued"
        p.drain()
        assert p.port.conservation()["ok"]
        p.check_oracle()
        p.close()

    def test_queue_full_fast_reject(self):
        p = Planes(max_queue=3, session_credits=100)
        rs = [p.submit(i + 1, 1, 100 + i * 10) for i in range(5)]
        assert [r.state for r in rs[:3]] == ["queued"] * 3
        assert {r.shed.reason for r in rs[3:]} == {"queue_full"}
        cons = p.port.conservation()
        assert cons["ok"] and cons["queued"] == 3 and cons["shed"] == 2
        p.same()

    def test_shed_is_returned_never_raised(self):
        p = Planes(session_credits=0)
        r = p.submit(1, 1, 100)
        assert r.state == "shed" and r.shed.reason == "no_credit"
        assert r.shed.reason in TA.SHED_REASONS
        assert TA.SHED_REASONS == JA.SHED_REASONS
        assert r.shed.retry_after_ms == pytest.approx(100.0)


class TestDeadlineSweep:
    def test_expired_queued_requests_shed_not_admitted_late(self):
        p = Planes(stage_ahead=False, max_windows_per_pump=0)
        r = p.submit(1, 1, 100, cls="critical")
        p.advance(0.5)
        p.pump()
        assert r.state == "shed" and r.shed.reason == "deadline"
        assert p.submit(1, 1, 200).state == "queued"
        assert p.port.conservation()["ok"]

    def test_admitted_wait_bounded_by_deadline(self):
        p = Planes(stage_ahead=False, prepare_max=1, window_prepares=1,
                   session_credits=100, max_queue=100)
        p.force(0)
        nid = 10 ** 4
        for _ in range(20):
            for sid in (1, 2, 3):
                p.submit(sid, 1, nid, cls="batch")
                nid += 1
            p.pump()
            p.advance(0.1)
        p.drain()
        st = p.port.stats()["classes"]["batch"]
        assert st["shed"].get("deadline", 0) > 0
        mx = st["admit_wait_ms"]["max"]
        assert mx is not None and mx <= CLASSES[2][3] + 1e-6
        p.check_oracle()
        p.close()


class TestShedLine:
    def test_rises_one_class_per_tick_top_class_never(self):
        p = Planes(stage_ahead=False, max_windows_per_pump=0,
                   session_credits=100)
        nid = 10 ** 4
        for _ in range(4):
            p.submit(1, 1, nid, cls="batch")
            p.submit(2, 1, nid + 1, cls="standard")
            nid += 2
        p.advance(0.2)
        p.pump()
        assert p.port.shed_level == 0
        p.pump()
        assert p.port.shed_level == 1
        assert p.submit(3, 1, nid, cls="batch").shed.reason == "shed_line"
        p.pump()
        assert p.port.shed_level == 2
        assert p.submit(3, 1, nid + 1,
                        cls="standard").shed.reason == "shed_line"
        assert p.submit(3, 1, nid + 2, cls="critical").state == "queued"
        assert p.port.conservation()["ok"]

    def test_cools_down_after_clean_ticks(self):
        p = Planes(stage_ahead=False, max_windows_per_pump=0,
                   session_credits=100, burn_window_ticks=4, cool_ticks=2)
        for i in range(3):
            p.submit(1, 1, 10 ** 4 + i, cls="batch")
        p.advance(0.2)
        p.pump()
        p.pump()
        assert p.port.shed_level >= 1
        levels = []
        for _ in range(16):
            p.pump()
            levels.append(p.port.shed_level)
        assert p.port.shed_level == 0
        assert sorted(levels, reverse=True) == levels

    def test_force_shed_level_pins_and_releases(self):
        p = Planes(stage_ahead=False, max_windows_per_pump=0)
        p.force(2)
        assert p.submit(1, 1, 100, cls="batch").shed.reason == "shed_line"
        assert p.submit(1, 1, 200, cls="standard").shed.reason == \
            "shed_line"
        assert p.submit(1, 1, 300, cls="critical").state == "queued"
        p.force(None)
        for _ in range(16):
            p.pump()
        assert p.port.shed_level == 0
        assert p.port.conservation()["queued"] == 1

    def test_depth_signal_raises_line_without_burn(self):
        p = Planes(stage_ahead=False, max_windows_per_pump=0,
                   session_credits=100, max_queue=8,
                   depth_shed_fraction=0.5)
        for i in range(4):
            p.submit(i + 1, 1, 100 + i, cls="batch")
        p.pump()
        assert p.port.shed_level == 1


class TestConservationAndOracle:
    def test_conservation_and_history_bit_exact_with_sheds(self):
        p = Planes(session_credits=1, max_queue=8)
        nid = 10 ** 5
        for _ in range(6):
            for sid in range(1, 7):
                cls = ("critical" if sid == 1
                       else "standard" if sid < 4 else "batch")
                p.submit(sid, 2, nid, cls=cls)
                p.submit(sid, 2, nid + 2, cls=cls)
                nid += 4
            p.pump()
            p.advance(0.05)
        p.drain()
        cons = p.port.conservation()
        assert cons["ok"] and cons["queued"] == 0 and cons["staged"] == 0
        assert cons["shed"] > 0
        p.check_oracle()
        p.close()

    def test_stats_record_shape(self):
        p = Planes()
        p.submit(1, 2, 100, cls="critical")
        p.pump()
        p.drain()
        st = p.port.stats()
        assert set(st["classes"]) == {c[0] for c in CLASSES}
        cs = st["classes"]["critical"]
        assert cs["submitted"] == 1 and cs["admitted"] == 1
        assert cs["admit_wait_ms"]["count"] == 1
        assert st["conservation"]["ok"]
        p.close()


class TestStageAhead:
    def test_prestaged_window_is_consumed_not_restaged(self):
        p = Planes(stage_ahead=True, prepare_max=4, session_credits=100)
        nid = 10 ** 5
        for _ in range(5):
            for sid in (1, 2, 3, 4):
                p.submit(sid, 2, nid)
                nid += 2
            p.pump()
            p.advance(0.02)
        p.drain()
        for _, sup, _, _ in p.sides:
            st = sup.led.staging_stats
            assert st["staged"] > 0 and st["misses"] == 0, st
        assert (p.sides[0][1].led.staging_stats["staged"]
                == p.sides[1][1].led.staging_stats["staged"])
        p.check_oracle()
        p.close()

    def test_shed_mid_window_history_bit_exact(self):
        """The shed line slams shut mid-run: queued and stage-ahead
        batch-class members shed as shed_line; the committed history is
        an oracle replay of the admitted requests alone."""
        p = Planes(classes=TWO_CLASSES, seed=11, prepare_max=4,
                   window_prepares=2, session_credits=1, max_queue=256,
                   stage_ahead=True, burn_window_ticks=8, cool_ticks=4)
        reqs, nid = [], 10 ** 5
        for t in range(8):
            for sid in range(1, 5):
                cls = "critical" if sid == 1 else "batch"
                reqs.append(p.submit(sid, 2, nid, cls=cls))
                reqs.append(p.submit(sid, 2, nid + 2, cls=cls))
                nid += 4
            if t == 4:
                p.force(1)
            if t == 6:
                p.force(None)
            p.pump()
            p.advance(0.05)
        p.drain()
        shed = [r for r in reqs if r.state == "shed"]
        admitted = [r for r in reqs if r.state == "admitted"]
        assert shed and admitted
        assert {r.shed.reason for r in shed} >= {"no_credit", "shed_line"}
        p.check_oracle()
        mirror = p.sides[0][1].led.mirror.transfers
        assert not {e.id for r in shed for e in r.transfers} & set(mirror)
        assert {e.id for r in admitted for e in r.transfers} <= set(mirror)
        p.close()

    def test_staged_but_shed_window_never_commits(self):
        p = Planes(classes=TWO_CLASSES, seed=11, prepare_max=4,
                   window_prepares=2, session_credits=100, max_queue=256,
                   stage_ahead=True, burn_window_ticks=8, cool_ticks=4)
        nid = 2 * 10 ** 5
        for sid in range(1, 9):
            p.submit(sid, 2, nid, cls="batch")
            nid += 2
        p.pump()
        p.advance(0.02)
        plane = p.port
        assert plane._staged_next is not None
        staged_reqs = list(plane._staged_next[3])
        staged_ids = {e.id for r in staged_reqs for e in r.transfers}
        p.force(1)
        p.pump()
        assert all(r.state == "shed" and r.shed.reason == "shed_line"
                   for r in staged_reqs)
        p.drain()
        p.check_oracle()
        sup = p.sides[0][1]
        assert not staged_ids & set(sup.led.mirror.transfers)
        assert not staged_ids & set(sup.epoch_base.transfers)
        sup.led.shutdown_staging()
        assert sup.led._staged is None
        p.close()


def test_stall_signal_raises_the_line():
    """The ledger's host_stall_fraction above stall_shed_fraction with
    work queued raises the shed line one class, on both packages."""
    p = Planes(stage_ahead=False, max_windows_per_pump=0,
               session_credits=100)
    for plane, sup, _, _ in p.sides:
        plane.stall_shed_fraction = 0.9
        sup.led.staging_stats.update(stall_ms=9.5, work_ms=10.0)
    p.pump()
    assert p.port.shed_level == 0          # nothing queued
    p.submit(1, 1, 100, cls="batch")
    p.pump()
    assert p.port.shed_level == 1
    for _, sup, _, _ in p.sides:
        sup.led.staging_stats.update(stall_ms=1.0)
    for _ in range(3):
        p.pump()
    p.same()
