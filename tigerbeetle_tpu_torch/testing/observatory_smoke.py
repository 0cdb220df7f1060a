"""Performance-observatory smoke: profiler, memwatch, alerts, overhead.

The port's counterpart of the JAX package's
`testing/observatory_smoke.py`, the gate's `profile` leg. Four legs, each
with its negative arm:

1. `_profiler_check` — a seeded serving workload at sampling 1/1 lands a
   non-empty `dispatch_device_time` series for every route it drives
   (chain and per_batch); the static cost model, at the sampled windows'
   shape, carries FLOPs and device bytes for the flat and chain tiers,
   and each tier's achieved-vs-roofline fraction is finite and positive.
   Sampler decimation is exact (1-in-3 over 7 dispatches samples 3).
2. `_memwatch_check` — the live watermark at the budget's caps audits
   green against the port's committed trace/membudget.json, the static
   state components equal the measured ones exactly, and the leak
   negative (a ledger with its transfer cap doubled) reds on the grown
   component.
3. `_alerts_check` — a seeded latency burn fires the page-severity
   `window_latency_burn` rule (typed alert, runbook anchor,
   `alert:<rule>` tail retention, a frozen flight artifact); the same
   burn with the rule disabled stays silent; a healthy feed resolves
   the alert after its hysteresis; a rule over an undeclared objective
   is a load-time ValueError.
4. `_overhead_check` — the same workload with the whole observatory on
   (the profiler at 1-in-8, memwatch, the alert engine) against off,
   the two arms in turns call by call, the median of paired ratios (as
   chip_smoke.py's observatory leg (d): one pair's ratio moves ~20% on
   the card's shared host, too much for the JAX leg's least of 5 reps a
   side); at or below the membudget's
   `profiler.overhead_ratio_max` (1.05). A clock reading: asserted on
   the card, measured everywhere.

``observatory_smoke(device=None)``;
``python -m tigerbeetle_tpu_torch.testing.observatory_smoke``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

SEED = 20
CAPS = (1 << 9, 1 << 11)


def _new_supervisor(device, tracer=None, *, caps=CAPS, **kw):
    from ..serving import ServingSupervisor
    from ..types import Account

    sup = ServingSupervisor(caps[0], caps[1], epoch_interval=4,
                            tracer=tracer, device=device, **kw)
    sup.create_accounts([Account(id=i, ledger=1, code=1)
                         for i in range(1, 9)], 10 ** 9)
    return sup


class _Workload:
    """The legs' deterministic transfer stream over accounts 1..8."""

    def __init__(self, seed: int = SEED):
        self.rng = np.random.default_rng(seed)
        self.ts = 2 * 10 ** 9
        self.tid = 1

    def batch(self, n: int):
        from ..types import Transfer

        out = []
        for _ in range(n):
            dr, cr = (int(x) for x in self.rng.choice(
                np.arange(1, 9), 2, replace=False))
            out.append(Transfer(id=self.tid, debit_account_id=dr,
                                credit_account_id=cr, amount=1,
                                ledger=1, code=1))
            self.tid += 1
        return out

    def window(self, sup, shape=(64, 64)):
        batches = [self.batch(n) for n in shape]
        tss = [self.ts + i * 10 ** 6 for i in range(len(shape))]
        self.ts += 10 ** 7
        return sup.create_transfers_window(batches, tss)


def _profiler_check(device) -> dict:
    """Leg 1: per-route dispatch series, the cost model at the sampled
    shape, the roofline fractions, exact decimation."""
    from ..trace import DispatchProfiler, Tracer, profile_probe

    tracer = Tracer()
    prof = DispatchProfiler(tracer=tracer, sample_every=1)
    sup = _new_supervisor(device, tracer, profiler=prof)
    wl = _Workload()
    for _ in range(4):
        wl.window(sup, (64, 64))   # W = 2: the chain route
    for _ in range(2):
        wl.window(sup, (8,))       # one small prepare: per batch
    rec = profile_probe(tracer=tracer, profiler=prof, depth=2,
                        device=device, caps=CAPS, batch=64)
    sup.led.release()
    measured = rec["dispatch_device_time"]
    routes = {m["route"] for m in measured.values() if m["count"]}
    assert {"chain", "per_batch"} <= routes, \
        f"dispatch_device_time misses a driven route: {sorted(routes)}"
    assert all(m["count"] and m["p50_us"] and m["p50_us"] > 0
               for m in measured.values()), measured
    tiers = rec["cost_model"]["tiers"]
    for tier in ("flat", "chain"):
        row = tiers.get(tier) or {}
        assert row.get("flops") and row.get("hbm_bytes"), \
            f"the cost model has no FLOPs or bytes for {tier!r}: {row}"
        frac = (rec["roofline"].get(tier) or {}).get("fraction")
        assert frac and 0.0 < frac < float("inf"), \
            f"no finite roofline fraction for {tier!r}: {frac}"
    assert prof.samples == prof.dispatches, prof.stats()
    p3 = DispatchProfiler(sample_every=3)
    for _ in range(7):
        p3.time(lambda: 0, route="r", tier="t")
    assert (p3.dispatches, p3.samples) == (7, 3), p3.stats()
    return {"routes": sorted(routes),
            "fractions": {t: rec["roofline"][t]["fraction"]
                          for t in rec["roofline"]},
            "cost_model_launches": {t: r.get("launches")
                                    for t, r in tiers.items()}}


def _memwatch_check(device) -> dict:
    """Leg 2: the committed budget green at its caps, static == measured
    on the state components, the leak red."""
    from ..trace import (MemWatch, Tracer, check_budget, load_budget,
                         measure_ledger, static_ledger)
    from ..trace.event import Event

    budget = load_budget()
    assert budget and budget.get("components"), "no committed membudget"
    caps = (budget["caps"]["a_cap"], budget["caps"]["t_cap"])
    tracer = Tracer()
    mw = MemWatch(tracer=tracer)
    sup = _new_supervisor(device, tracer, caps=caps, memwatch=mw)
    wl = _Workload(SEED + 1)
    for _ in range(4):
        wl.window(sup, (32,))
    assert sup.verify_epoch()
    assert mw.observations >= 1, mw.stats()
    assert mw.reds == [] and mw.last.get("budget_ok") is True, mw.stats()
    assert mw.last["headroom_bytes"] >= 0, mw.last
    assert Event.memory_watermark_bytes.name in tracer.emitted
    assert Event.memory_budget_headroom_bytes.name in tracer.emitted
    static = static_ledger(*caps)
    for name, pin in static["components"].items():
        if name.startswith("state."):
            assert mw.last["components"][name] == pin, \
                (name, pin, mw.last["components"].get(name))
    sup.led.release()
    # The leak: the same audit against a ledger whose transfer store
    # doubled must red on the grown component.
    leaked = _new_supervisor(device, caps=(caps[0], 2 * caps[1]))
    reds = check_budget(measure_ledger(leaked.led), budget)
    leaked.led.release()
    assert reds, "the injected leak audited green"
    assert any("state.transfers" in r for r in reds), reds
    return {"observations": mw.observations,
            "headroom": mw.last["headroom_bytes"], "leak_reds": len(reds)}


def _alerts_check() -> dict:
    """Leg 3: the burn pages, the disabled arm stays silent, a healthy
    feed resolves, a dead rule is a ValueError."""
    from ..trace import (AlertEngine, FlightRecorder, Tracer,
                         load_alert_rules, mint_context)
    from ..trace.event import Event
    from ..trace.slo import DEFAULT_SLO_PATH

    loaded = load_alert_rules()
    rules = {r.name: r for r in loaded["rules"]}
    assert "window_latency_burn" in rules, sorted(rules)
    assert rules["window_latency_burn"].severity == "page"

    def burn(eng, tracer, n_ticks, dur_ms):
        for i in range(n_ticks):
            tracer.record_span(
                Event.window_commit, tracer.now_ns(), int(dur_ms * 1e6),
                ctx=mint_context(7, i), route="chain", tier="scan")
            eng.tick()

    with tempfile.TemporaryDirectory() as td:
        tracer = Tracer()
        flight = FlightRecorder(pid=0, tracer=tracer, dump_dir=td)
        eng = AlertEngine(tracer=tracer, flight=flight, tick_every=1)
        burn(eng, tracer, 8, 600.0)   # far above the 400 ms objective
        assert "window_latency_burn" in eng.active, eng.stats()
        alert = eng.active["window_latency_burn"]
        assert alert.severity == "page"
        assert "monitoring.md#alert-window-latency-burn" in alert.runbook
        assert alert.value and alert.value > 400.0, alert.to_dict()
        assert alert.fast_burn_rate >= 0.5, alert.to_dict()
        assert alert.trace_ids, "a page fired without exemplar traces"
        assert any(r == "alert:window_latency_burn"
                   for r in tracer.kept_traces.values()), \
            tracer.kept_traces
        assert flight.dumps == 1 and alert.flight_path and \
            os.path.exists(alert.flight_path), alert.to_dict()
        assert tracer.counters.get(Event.alert_fired.name) == 1
        assert "dispatch_latency_burn" not in eng.active, eng.stats()
        burn(eng, tracer, rules["window_latency_burn"].hysteresis, 1.0)
        assert "window_latency_burn" not in eng.active, eng.stats()
        assert eng.fired[0].resolved_tick is not None

        tracer2 = Tracer()
        flight2 = FlightRecorder(pid=0, tracer=tracer2, dump_dir=td)
        eng2 = AlertEngine(
            [r for r in loaded["rules"] if r.name != "window_latency_burn"],
            loaded["objectives"], tracer=tracer2, flight=flight2,
            tick_every=1)
        burn(eng2, tracer2, 8, 600.0)
        assert not eng2.active and flight2.dumps == 0, eng2.stats()

        with open(DEFAULT_SLO_PATH) as f:
            cfg = json.load(f)
        cfg["alerts"] = [dict(cfg["alerts"][0],
                              objective="no_such_objective")]
        dead = os.path.join(td, "slo_dead.json")
        with open(dead, "w") as f:
            json.dump(cfg, f)
        try:
            load_alert_rules(dead)
        except ValueError as e:
            assert "no_such_objective" in str(e), e
        else:
            raise AssertionError("a dead alert rule loaded green")
    return {"fired": len(eng.fired),
            "resolved_tick": eng.fired[0].resolved_tick}


# On/off pairs the overhead leg times: on the card the median of many
# pairs' ratios, as chip_smoke.py's observatory leg (d) (one pair's ratio
# moves ~20% on the card's shared host); off it (measured, not asserted)
# a few.
OVERHEAD_PAIRS = 20
OVERHEAD_PAIRS_UNTIMED = 3


def _overhead_check(device, pairs: int = OVERHEAD_PAIRS,
                    timing: bool = True) -> dict:
    """Leg 4: a run (6 windows of 48 + 48 and a verified epoch) with the
    whole observatory on against off. A pair: two supervisors, each
    warmed by 2 windows and an epoch, the observatory then attached to
    one; the two take their run in turns, call by call (the order flipped
    every call, no collector pause inside the clock), so both see the
    same stretch of the host. One warm pair first; the median of the
    pairs' on/off ratios."""
    import gc

    import torch

    from ..trace import (AlertEngine, DispatchProfiler, MemWatch, Tracer,
                         load_budget)

    ratio_max = load_budget()["profiler"]["overhead_ratio_max"]
    cuda = torch.device(device).type == "cuda"

    def arm(observatory: bool):
        tracer = Tracer()
        sup = _new_supervisor(device, tracer)
        wl = _Workload(SEED + 2)
        for _ in range(2):
            wl.window(sup, (48, 48))
        assert sup.verify_epoch()
        if observatory:
            sup.profiler = DispatchProfiler(tracer=tracer, sample_every=8)
            sup.memwatch = MemWatch(tracer=tracer)
            sup.alert_engine = AlertEngine(tracer=tracer, tick_every=4)
            sup.alert_engine.bind(sup.tracer, sup.flight)
        return sup, wl

    def step(sup, wl, k: int) -> None:
        if k < 6:
            wl.window(sup, (48, 48))
            return
        assert sup.verify_epoch()
        if cuda:
            torch.cuda.synchronize(device)

    times = {True: [], False: []}
    for r in range(pairs + 1):
        arms = {on: arm(on) for on in (True, False)}
        dt = {True: 0.0, False: 0.0}
        if cuda:
            torch.cuda.synchronize(device)
        gc.collect()
        gc.disable()
        try:
            for k in range(7):
                for on in ((True, False) if k % 2 else (False, True)):
                    t0 = time.perf_counter()
                    step(*arms[on], k)
                    dt[on] += time.perf_counter() - t0
        finally:
            gc.enable()
        for sup, _ in arms.values():
            sup.led.release()
        if r:
            for on in (True, False):
                times[on].append(dt[on])
    ratio = float(np.median([a / b for a, b in zip(times[True],
                                                   times[False])]))
    if timing:
        assert ratio <= ratio_max, (
            f"observatory overhead ratio {ratio:.4f} > {ratio_max} (median "
            f"of {pairs} pairs; on {np.median(times[True]) * 1e3:.1f} ms, "
            f"off {np.median(times[False]) * 1e3:.1f} ms a run)")
    return dict(ratio=ratio, ratio_max=ratio_max, pairs=pairs,
                on_ms=float(np.median(times[True])) * 1e3,
                off_ms=float(np.median(times[False])) * 1e3)


def observatory_smoke(device=None) -> dict:
    """The four legs on `device` (None: the card; there the overhead
    ratio must lie within its bound). Returns each leg's summary."""
    from ..ops.device import resolve_device

    device = resolve_device(device)
    timing = device.type == "cuda"
    return {"profiler": _profiler_check(device),
            "memwatch": _memwatch_check(device),
            "alerts": _alerts_check(),
            "overhead": _overhead_check(
                device, OVERHEAD_PAIRS if timing else OVERHEAD_PAIRS_UNTIMED,
                timing)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    out = observatory_smoke(args.device)
    print(f"[observatory-smoke] ok: routes {out['profiler']['routes']} "
          f"profiled with roofline fractions, membudget green (headroom "
          f"{out['memwatch']['headroom']} B) with the leak red, the page "
          f"fired and resolved, the disabled arm silent, the dead rule a "
          f"ValueError, overhead ratio {out['overhead']['ratio']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
