"""Overload smoke: the gate's proof that the admission plane degrades
into explicit, typed, SLO-preserving load shedding under a 100,000-session
Zipfian overload — and that the proof can fail.

The port's counterpart of the JAX package's `testing/overload_smoke.py`.
Drives `admission.py` in front of a real ServingSupervisor on a seeded,
virtual-clock overload (offered load ~2x the pump's window capacity,
sessions drawn Zipfian-hot from a population of 100,000) and asserts:

  1. ZERO SILENT DROPS: submitted == admitted + shed exactly, every
     rejection a typed ShedResult whose trace is tail-kept under a
     ``shed:<reason>`` retention reason;
  2. SLO UNDER SHEDDING: at least one class sheds, the top class never
     for its shed line or a deadline, and every class's ADMITTED
     queue-wait p99 within its slo_ms (CLASSES below);
  3. BIT-EXACT: the admitted history (statuses and timestamps) equals an
     oracle replay of exactly the admitted requests, and the epoch
     verify passes;
  4. THE NEGATIVE REDS: the same offered load with the shed line off
     (unbounded credits and queue) admits everything, its p99 collapses
     past the largest budget, and the predicate fails.

The clock is virtual, so every wait is deterministic on any device.

``overload_smoke(device=None)``;
``python -m tigerbeetle_tpu_torch.testing.overload_smoke [--device cpu]``.
"""

from __future__ import annotations

import time

import numpy as np

from ..admission import AdmissionClass

SEED = 83
SESSIONS = 100_000     # the Zipfian session population
ZIPF_THETA = 1.1       # hot-session skew
N_ACCOUNTS = 128
A_CAP, T_CAP = 1 << 10, 1 << 15
TXNS_PER_REQ = 4       # small client requests, coalesced by the plane
REQS_PER_ROUND = 120   # offered: 480 events a round
ROUNDS = 30
NEG_ROUNDS = 20        # enough for the no-shed arm's p99 to collapse
TICK_S = 0.020         # virtual seconds a pump round
PREPARE_MAX = 64       # events a prepare
WINDOW_PREPARES = 2
MAX_WINDOWS = 2        # capacity: 256 events a round against 480 offered

# Per-class admission budgets (virtual ms), the JAX package's: slo_ms is
# the admitted queue-wait p99 the gate asserts, deadline_ms the hard
# per-request bound the deadline sweep enforces.
CLASSES = (
    AdmissionClass("critical", 0, slo_ms=100.0, deadline_ms=400.0),
    AdmissionClass("standard", 1, slo_ms=200.0, deadline_ms=600.0),
    AdmissionClass("batch", 2, slo_ms=300.0, deadline_ms=300.0),
)


def _mk_requests(zipf, rng, round_i, next_id):
    """One round's offered load: REQS_PER_ROUND requests from Zipfian-hot
    sessions, the class from the session id (10% critical, 30% standard,
    60% batch)."""
    from ..types import Transfer

    out = []
    sids = zipf.draw(REQS_PER_ROUND)
    for s in sids.tolist():
        sid = int(s) + 1
        m = sid % 10
        cls = "critical" if m == 0 else "standard" if m <= 3 else "batch"
        evs = []
        for _ in range(TXNS_PER_REQ):
            dr = int(rng.integers(1, N_ACCOUNTS + 1))
            cr = dr % N_ACCOUNTS + 1
            evs.append(Transfer(
                id=next_id, debit_account_id=dr, credit_account_id=cr,
                amount=int(rng.integers(1, 100)), ledger=1, code=1))
            next_id += 1
        out.append((sid, cls, evs))
    return out, next_id


def _run_arm(shed_enabled, rounds, device):
    """One seeded overload arm: (plane, supervisor, tracer, requests)."""
    from ..admission import AdmissionPlane, VirtualClock
    from ..serving import ServingSupervisor
    from ..trace import Tracer
    from ..types import Account
    from ..utils.zipfian import ZipfianGenerator

    tracer = Tracer(pid=0)
    clock = VirtualClock()
    sup = ServingSupervisor(A_CAP, T_CAP, epoch_interval=16,
                            sleep=lambda s: None, seed=SEED, tracer=tracer,
                            device=device)
    plane = AdmissionPlane(
        sup, classes=CLASSES, prepare_max=PREPARE_MAX,
        window_prepares=WINDOW_PREPARES, max_windows_per_pump=MAX_WINDOWS,
        session_credits=4 if shed_enabled else 1 << 30,
        max_queue=4096 if shed_enabled else 1 << 30,
        burn_window_ticks=4, burn_budget=0.25, cool_ticks=4,
        shed_enabled=shed_enabled, clock=clock, seed=SEED, head_rate=0.05)
    plane.open_accounts([Account(id=i, ledger=1, code=1)
                         for i in range(1, N_ACCOUNTS + 1)], N_ACCOUNTS + 10)
    zipf = ZipfianGenerator(SESSIONS, theta=ZIPF_THETA, seed=SEED)
    rng = np.random.default_rng(SEED)
    next_id = 10 ** 6
    reqs = []
    for round_i in range(rounds):
        offered, next_id = _mk_requests(zipf, rng, round_i, next_id)
        for sid, cls, evs in offered:
            reqs.append(plane.submit(sid, evs, cls=cls))
        plane.pump()
        clock.advance(TICK_S)
    plane.drain()
    assert sup.verify_epoch(), \
        f"overload epoch verify failed: {sup.last_recovery}"
    assert sup.last_recovery is None, sup.last_recovery
    sup.led.shutdown_staging()
    return plane, sup, tracer, reqs


def predicate(plane) -> bool:
    """The gate predicate: conservation, a class shed, and every class's
    admitted p99 within its budget. The negative arm must fail it."""
    cons = plane.conservation()
    st = plane.stats()
    any_shed = any(st["classes"][c.name]["shed"] for c in CLASSES)
    p99_ok = True
    for c in CLASSES:
        p99 = st["classes"][c.name]["admit_wait_ms"]["p99"]
        if p99 is not None and p99 > c.slo_ms:
            p99_ok = False
    return bool(cons["ok"] and cons["queued"] == 0 and any_shed and p99_ok)


def overload_smoke(device=None) -> dict:
    """Both arms on `device` (None: the card). Returns the conservation,
    the per-class stats, the admitted history and the negative's worst
    p99; raises on any failure."""
    from ..admission import ShedResult
    from ..ops.device import resolve_device

    device = resolve_device(device)
    t0 = time.monotonic()
    plane, sup, tracer, reqs = _run_arm(True, ROUNDS, device)
    wall_s = time.monotonic() - t0
    st = plane.stats()
    cons = plane.conservation()

    # 1. Zero silent drops.
    assert cons["ok"] and cons["queued"] == 0 and cons["staged"] == 0, cons
    n_shed = sum(1 for r in reqs if r.state == "shed")
    n_adm = sum(1 for r in reqs if r.state == "admitted")
    assert n_adm + n_shed == len(reqs), (n_adm, n_shed, len(reqs))
    assert n_shed == cons["shed"] and n_adm == cons["admitted"], cons
    for r in reqs:
        if r.state == "shed":
            assert isinstance(r.shed, ShedResult), r.shed
            kept = tracer.kept_traces.get(r.shed.trace_id)
            assert kept is not None and kept.startswith("shed:"), \
                (r.shed, kept)

    # 2. The SLO under shedding; the top class sheds only for credit or a
    # full queue (the hot-session backpressure every class has).
    shed_classes = [c.name for c in CLASSES if st["classes"][c.name]["shed"]]
    assert shed_classes, "the overload arm shed nothing: not an overload"
    crit_reasons = set(st["classes"]["critical"]["shed"])
    assert crit_reasons <= {"no_credit", "queue_full"}, \
        (st["classes"]["critical"], "the top class shed for its line")
    for c in CLASSES:
        cs = st["classes"][c.name]
        p99 = cs["admit_wait_ms"]["p99"]
        assert p99 is not None and p99 <= c.slo_ms, (
            f"{c.name} admitted p99 {p99} ms breached its budget "
            f"{c.slo_ms} ms under shedding ({cs})")
        mx = cs["admit_wait_ms"]["max"]
        assert mx is not None and mx <= c.deadline_ms + 1e-6, \
            (c.name, mx, c.deadline_ms)
    assert predicate(plane), "the positive arm failed its own predicate"

    # 3. Bit-exact: the admitted history equals an oracle replay of the
    # admitted requests.
    hist, _oracle = plane.oracle_history()
    assert hist == sup.history, \
        "the admitted history diverged from the admitted-only replay"

    # 4. The negative: no shed line, the same offered load.
    neg_plane, neg_sup, _nt, _nr = _run_arm(False, NEG_ROUNDS, device)
    nst = neg_plane.stats()
    assert neg_plane.conservation()["shed"] == 0, nst
    worst = max(nst["classes"][c.name]["admit_wait_ms"]["p99"] or 0.0
                for c in CLASSES)
    worst_budget = max(c.slo_ms for c in CLASSES)
    assert worst > worst_budget, (
        f"the no-shed arm's p99 {worst} ms did not collapse past the "
        f"largest budget {worst_budget} ms: the negative proves nothing")
    assert not predicate(neg_plane), \
        f"the shed-disabled arm passed the predicate (worst p99 {worst} ms)"
    nhist, _no = neg_plane.oracle_history()
    assert nhist == neg_sup.history, "the no-shed arm's history diverged"
    for s in (sup, neg_sup):
        s.led.release()
    return dict(conservation=cons, shed_classes=shed_classes,
                classes={c.name: {k: st["classes"][c.name][k]
                                  for k in ("shed", "admit_wait_ms")}
                         for c in CLASSES},
                sessions=st["sessions"],
                events_admitted=st["events_admitted"], history=hist,
                admitted_log=list(plane.admitted_log),
                negative_worst_p99_ms=worst, wall_s=wall_s)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    out = overload_smoke(args.device)
    c = out["conservation"]
    print(f"[overload-smoke] ok: {c['submitted']} requests from "
          f"{out['sessions']} live sessions (population {SESSIONS}), "
          f"{c['admitted']} admitted / {c['shed']} shed (classes "
          f"{out['shed_classes']}), per-class p99 within budget, history "
          f"bit-exact, the no-shed negative reds (worst p99 "
          f"{out['negative_worst_p99_ms']:.0f} ms)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
