"""Port parity: the performance observatory, on the CPU.

- memwatch: the port's `static_ledger` against the JAX package's at the
  caps of `perf/membudget_r01.json`, component by component: every
  state store is equal; the staged pack is the one that differs (named
  below, with why), so the port pins its own budget,
  `tigerbeetle_tpu_torch/trace/membudget.json`, which must equal its
  static ledger at those caps, with the JAX file's tolerance and
  profiler ceiling. `check_budget` and `load_budget` against the JAX
  functions on the same dicts and files. A supervisor at the budget's
  caps audits green, its state components equal the static ones
  exactly, and the doubled-`t_cap` leak REDs on the grown components
  and the total.
- alerts: `AlertEngine` fed the same seeded window_commit stream as the
  JAX package's engine (a burn, a healthy stretch, a second burn,
  unknown ticks): the same fired and resolved ticks, the same stats, the
  same kept traces; the disabled arm stays silent; a dead rule is a
  ValueError.
- profiler: sampling is exactly 1-in-N; `measured_dispatch_us` and
  `roofline_fractions` equal the JAX package's on the same tracer
  records; the static cost model gives FLOPs and bytes for the flat and
  chain tiers and takes its scratch run's launches back out; the
  supervisor's profiled windows land a series for each route driven, and
  a capture leaves a Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.trace import alerts as JA
from tigerbeetle_tpu.trace import memwatch as JM
from tigerbeetle_tpu.trace import profiler as JP
from tigerbeetle_tpu.trace import tracer as JT
from tigerbeetle_tpu.trace.context import mint_context as j_mint
from tigerbeetle_tpu.trace.event import Event as JEvent
from tigerbeetle_tpu.trace.flight_recorder import FlightRecorder as JFlight
from tigerbeetle_tpu_torch import ServingSupervisor
from tigerbeetle_tpu_torch.ops import fused_probe, row_gather
from tigerbeetle_tpu_torch.parallel import partitioned as TPART
from tigerbeetle_tpu_torch.trace import alerts as TA
from tigerbeetle_tpu_torch.trace import memwatch as TM
from tigerbeetle_tpu_torch.trace import profiler as TP
from tigerbeetle_tpu_torch.trace import tracer as TT
from tigerbeetle_tpu_torch.trace.context import mint_context as t_mint
from tigerbeetle_tpu_torch.trace.event import Event as TEvent
from tigerbeetle_tpu_torch.trace.flight_recorder import FlightRecorder as TFlight
from tigerbeetle_tpu_torch.types import Account, Transfer

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

JAX_BUDGET = os.path.join(os.path.dirname(__file__), "..", "perf",
                          "membudget_r01.json")
# The one component where the port's footprint differs: its window pack
# is one int64 lane matrix (23 lanes: the event lanes, valid and the
# three seg lanes), where the JAX package stages each column at its own
# width plus a timestamp and a count lane a prepare.
DIFFERS = {"staged_pack"}


def _jax_budget() -> dict:
    with open(JAX_BUDGET) as f:
        return json.load(f)


# ---------------------------------------------------------------- memwatch

@pytest.mark.parametrize("n_shards", [1, 8])
def test_static_ledger_equals_the_jax_packages_but_the_staged_pack(n_shards):
    caps = _jax_budget()["caps"]
    kw = dict(window_depth=caps["window_depth"], n_pad=caps["n_pad"],
              n_shards=n_shards)
    got = TM.static_ledger(caps["a_cap"], caps["t_cap"], **kw)
    want = JM.static_ledger(caps["a_cap"], caps["t_cap"], **kw)
    assert got["caps"] == want["caps"]
    assert set(got["components"]) == set(want["components"])
    differ = {k for k in got["components"]
              if got["components"][k] != want["components"][k]}
    assert differ == DIFFERS
    from tigerbeetle_tpu_torch.ops.ledger import _LANES
    assert got["components"]["staged_pack"] == (
        len(_LANES) * 8 * caps["n_pad"] * TM.STAGED_PACK_DEPTH)
    assert got["per_device_bytes"] == got["total_bytes"] // n_shards
    # Every state store equals the JAX package's pin too.
    pinned = _jax_budget()["components"]
    for k, v in got["components"].items():
        if k.startswith("state.") and n_shards == 1:
            assert v == pinned[k], k


def test_the_ports_budget_is_its_static_ledger_at_the_jax_caps():
    jb = _jax_budget()
    tb = TM.load_budget()
    caps = jb["caps"]
    # The budget covers the partitioned attach mode on the JAX budget's
    # 8-way mesh, as the JAX package's pins do.
    static = TM.static_ledger(caps["a_cap"], caps["t_cap"],
                              window_depth=caps["window_depth"],
                              n_pad=caps["n_pad"], partitioned_shards=8)
    assert tb["caps"] == caps == static["caps"]
    assert tb["components"] == static["components"]
    assert tb["total_bytes"] == static["total_bytes"]
    assert tb["tolerance"] == jb["tolerance"]
    assert tb["profiler"] == jb["profiler"]
    assert TPART.TEL_WORDS * 4 * 8 * 8 == jb["components"]["telemetry_block"]
    assert TM.telemetry_block_bytes(8, 8) == JM.telemetry_block_bytes(8, 8)
    assert not hasattr(TM, "TEL_WORDS")   # it lives with the route
    for k in ("partitioned_state", "telemetry_block"):
        assert tb["components"][k] == jb["components"][k], k


MEASURED = [
    {"components": {"state.accounts": 98500, "staged_pack": 0},
     "total_bytes": 98500},
    {"components": {"state.accounts": 98500 * 2, "staged_pack": 0},
     "total_bytes": 98500 * 2},
    {"components": {"state.accounts": 98500, "novel": 8},
     "total_bytes": 98508},
    {"components": {"state.accounts": 98500, "novel": 0},
     "total_bytes": 10 ** 9},
    {"components": {"state.accounts": int(98500 * 1.02) + 1},
     "total_bytes": 5},
]


@pytest.mark.parametrize("case", range(len(MEASURED)))
def test_check_budget_equals_the_jax_packages(case):
    for budget in (_jax_budget(), TM.load_budget(),
                   {"components": {"state.accounts": 98500},
                    "total_bytes": 100_000}):
        assert (TM.check_budget(MEASURED[case], budget)
                == JM.check_budget(MEASURED[case], budget))


def test_load_budget_equals_the_jax_packages(tmp_path):
    assert TM.load_budget(JAX_BUDGET) == JM.load_budget(JAX_BUDGET)
    bad = tmp_path / "membudget_r99.json"
    bad.write_text(json.dumps({"components": {}}))
    for mod in (TM, JM):
        with pytest.raises(ValueError, match="total_bytes"):
            mod.load_budget(str(bad))


def _supervisor(tracer=None, *, a_cap=1 << 9, t_cap=1 << 11, **kw):
    sup = ServingSupervisor(a_cap=a_cap, t_cap=t_cap, epoch_interval=4,
                            tracer=tracer, device="cpu", **kw)
    sup.create_accounts([Account(id=i, ledger=1, code=1)
                         for i in range(1, 9)], 10 ** 9)
    return sup


def _window(sup, rng, tid, ts, shape):
    batches = []
    for n in shape:
        b = []
        for _ in range(n):
            dr, cr = (int(x) for x in rng.choice(np.arange(1, 9), 2,
                                                 replace=False))
            b.append(Transfer(id=tid, debit_account_id=dr,
                              credit_account_id=cr, amount=1, ledger=1,
                              code=1))
            tid += 1
        batches.append(b)
    sup.create_transfers_window(batches,
                                [ts + i * 10 ** 6 for i in range(len(shape))])
    return tid


def test_memwatch_green_exact_and_the_leak_reds():
    tracer = TT.Tracer()
    mw = TM.MemWatch(tracer=tracer)
    sup = _supervisor(tracer, memwatch=mw)
    rng = np.random.default_rng(21)
    tid, ts = 1, 2 * 10 ** 9
    for _ in range(4):
        tid = _window(sup, rng, tid, ts, (32,))
        ts += 10 ** 7
    assert sup.verify_epoch()
    assert mw.observations >= 1 and mw.reds == [], mw.stats()
    assert mw.last["budget_ok"] is True and mw.last["headroom_bytes"] >= 0
    assert TEvent.memory_watermark_bytes.name in tracer.emitted
    assert TEvent.memory_budget_headroom_bytes.name in tracer.emitted
    static = TM.static_ledger(1 << 9, 1 << 11)
    for name, pin in static["components"].items():
        if name.startswith("state."):
            assert mw.last["components"][name] == pin, name
    assert sup.stats()["observatory"]["memwatch"]["observations"] >= 1


def _staged_worst_case(t_cap):
    """A ledger at the budget's a_cap holding the worst-case staged pack:
    a window of STAGED_PACK_DEPTH prepares at the largest pad bucket,
    packed by the stager."""
    from tigerbeetle_tpu_torch.benchmark import _soa
    from tigerbeetle_tpu_torch.ops.ledger import DeviceLedger

    led = DeviceLedger(a_cap=1 << 9, t_cap=t_cap, device="cpu")
    led.overlap_staging = True
    n = 4097                               # pads to N_PAD
    evs = [_soa(np.arange(1 + k * n, 1 + (k + 1) * n), np.ones(n),
                np.full(n, 2), np.ones(n))
           for k in range(TM.STAGED_PACK_DEPTH)]
    assert led.stage_window(evs, [10 ** 9 + k * 10 ** 4
                                  for k in range(len(evs))])
    led._staged[-1].result()
    return led


def test_static_equals_measured_and_the_leak_reds():
    """With the worst-case pack staged, every measured component equals
    the static ledger's and the audit is green; with t_cap doubled, the
    grown stores and the total RED. The budget pins the partitioned
    attach mode's state too, so the leak grows t_cap 16-fold before the
    total passes it."""
    budget = TM.load_budget()
    static = TM.static_ledger(1 << 9, 1 << 11)["components"]
    assert static.pop("telemetry_block") == 0   # no partitioned mesh
    led = _staged_worst_case(1 << 11)
    measured = TM.measure_ledger(led)
    led.shutdown_staging()
    assert measured["components"] == static
    assert TM.check_budget(measured, budget) == []
    leaked = _staged_worst_case(1 << 15)
    reds = TM.check_budget(TM.measure_ledger(leaked), budget)
    leaked.shutdown_staging()
    assert len(reds) == 3, reds
    assert any("'state.transfers'" in r for r in reds), reds
    assert any("'state.events'" in r for r in reds), reds
    assert any("total watermark" in r for r in reds), reds


def test_device_memory_stats_on_the_cpu():
    from tigerbeetle_tpu_torch.ops.ledger import DeviceLedger

    got = TM.device_memory_stats()
    assert got == [{"device": "cpu", "platform": "cpu", "stats": None}]
    assert all(d["stats"] is None for d in JM.device_memory_stats())
    led = DeviceLedger(a_cap=1 << 6, t_cap=1 << 8, device="cpu")
    (entry,) = TM.device_memory_stats(led)
    assert entry["graph_pools"] == {"reserved": {}, "evictions": 0}


# ------------------------------------------------------------------ alerts

def _feed(pkg, seed):
    """Feed one engine the seeded stream; returns (engine, tracer,
    flight). Each step is (span ms or None for an unknown tick)."""
    A, T, mint, E, Flight, kw = pkg
    tracer = T.Tracer()
    flight = Flight(pid=0, tracer=tracer, **kw)
    eng = A.AlertEngine(tracer=tracer, flight=flight, tick_every=1)
    rng = np.random.default_rng(seed)
    plan = ([600.0 + 100 * rng.random() for _ in range(10)]
            + [None] * 3
            + [float(rng.integers(1, 50)) for _ in range(9)]
            + [500.0 + rng.random() for _ in range(12)])
    fired_at = []
    for i, ms in enumerate(plan):
        if ms is not None:
            tracer.record_span(E.window_commit, tracer.now_ns(),
                               int(ms * 1e6), ctx=mint(7, i),
                               route="chain", tier="scan")
        fired_at.append([a.rule for a in eng.tick()])
    return eng, tracer, flight, fired_at


def _strip(stats):
    """Stats with the alerts' flight paths aside (each package dumps into
    its own directory)."""
    out = json.loads(json.dumps(stats))
    for a in out["alerts"]:
        a.pop("flight_path")
    return out


@pytest.mark.parametrize("seed", [3, 8])
def test_alert_engine_equals_the_jax_packages(seed, tmp_path):
    t = _feed((TA, TT, t_mint, TEvent, TFlight,
               {"dump_dir": str(tmp_path / "t")}), seed)
    j = _feed((JA, JT, j_mint, JEvent, JFlight,
               {"out_dir": str(tmp_path / "j")}), seed)
    assert t[3] == j[3]
    assert _strip(t[0].stats()) == _strip(j[0].stats())
    assert t[1].kept_traces == j[1].kept_traces
    assert t[2].dumps == j[2].dumps >= 1
    fired = t[0].fired
    assert fired[0].rule == "window_latency_burn"
    assert fired[0].resolved_tick is not None
    assert fired[0].flight_path and os.path.exists(fired[0].flight_path)
    assert any(r == "alert:window_latency_burn"
               for r in t[1].kept_traces.values())


def test_disabled_rule_stays_silent_and_a_dead_rule_is_refused(tmp_path):
    loaded = TA.load_alert_rules()
    tracer = TT.Tracer()
    flight = TFlight(pid=0, tracer=tracer, dump_dir=str(tmp_path))
    eng = TA.AlertEngine(
        [r for r in loaded["rules"] if r.name != "window_latency_burn"],
        loaded["objectives"], tracer=tracer, flight=flight, tick_every=1)
    for i in range(8):
        tracer.record_span(TEvent.window_commit, tracer.now_ns(),
                           int(600e6), ctx=t_mint(7, i), route="chain",
                           tier="scan")
        eng.tick()
    assert not eng.active and flight.dumps == 0, eng.stats()
    from tigerbeetle_tpu_torch.trace.slo import DEFAULT_SLO_PATH
    with open(DEFAULT_SLO_PATH) as f:
        cfg = json.load(f)
    cfg["alerts"] = [dict(cfg["alerts"][0], objective="no_such_objective")]
    dead = tmp_path / "slo_dead.json"
    dead.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="no_such_objective"):
        TA.load_alert_rules(str(dead))
    with pytest.raises(ValueError, match="without objectives"):
        TA.AlertEngine(loaded["rules"], {})


def test_supervisor_ticks_its_alert_engine():
    tracer = TT.Tracer()
    eng = TA.AlertEngine(tick_every=2)
    sup = _supervisor(tracer, alert_engine=eng)
    assert eng.tracer is tracer and eng.flight is sup.flight
    rng = np.random.default_rng(5)
    tid = 1
    for k in range(5):
        tid = _window(sup, rng, tid, 2 * 10 ** 9 + k * 10 ** 7, (16, 16))
    assert eng.windows == 5 and eng.ticks == 3
    assert sup.stats()["observatory"]["alerts"]["windows"] == 5


# ---------------------------------------------------------------- profiler

@pytest.mark.parametrize("every, calls, samples", [(1, 5, 5), (3, 7, 3),
                                                   (8, 17, 3)])
def test_sampling_is_exactly_one_in_n(every, calls, samples):
    tracer = TT.Tracer()
    prof = TP.DispatchProfiler(tracer=tracer, sample_every=every)
    for i in range(calls):
        assert prof.time(lambda i=i: i, route="r", tier="t") == i
    assert (prof.dispatches, prof.samples) == (calls, samples)
    (series,) = TP.measured_dispatch_us(tracer).values()
    assert series["count"] == samples and series["route"] == "r"
    with pytest.raises(ValueError):
        TP.DispatchProfiler(sample_every=0)


def _records(tracer, seed):
    rng = np.random.default_rng(seed)
    for route, tier in (("chain", "scan"), ("per_batch", "fallback"),
                        ("super_deep", "flat")):
        for _ in range(int(rng.integers(3, 30))):
            tracer.observe(JEvent.dispatch_device_time
                           if isinstance(tracer, JT.Tracer)
                           else TEvent.dispatch_device_time,
                           float(rng.lognormal(7, 1)), route=route,
                           tier=tier)


def test_measured_dispatch_and_roofline_equal_the_jax_packages():
    t, j = TT.Tracer(), JT.Tracer()
    _records(t, 4)
    _records(j, 4)
    measured = TP.measured_dispatch_us(t)
    assert measured == JP.measured_dispatch_us(j)
    assert len(measured) == 3
    model = {"tiers": {
        "flat": {"route": "flat", "roofline_seconds": 2.5e-4},
        "chain": {"route": "chain", "roofline_seconds": 1e-3},
        "partitioned_chain": {"route": "partitioned_chain",
                              "roofline_seconds": 1e-3},
        "none": {"route": "flat"}}}
    got = TP.roofline_fractions(model, measured)
    assert got == JP.roofline_fractions(model, JP.measured_dispatch_us(j))
    assert set(got) == {"flat", "chain"}
    for platform in ("cpu",):
        for flops, nbytes in ((0, 0), (10 ** 9, 0), (5, 10 ** 9), (None, 7)):
            assert (TP.roofline_seconds(flops, nbytes, platform)
                    == JP.roofline_seconds(flops, nbytes, platform))
    assert TP.NOMINAL_PEAKS["cpu"] == JP.NOMINAL_PEAKS["cpu"]
    assert TP.NOMINAL_PEAKS["gpu"] == (67e12, 3.35e12)
    assert TP.ROUTE_ALIASES == JP.ROUTE_ALIASES


def test_static_cost_model_counts_the_flat_and_chain_tiers():
    before = (fused_probe.LAUNCHES, row_gather.LAUNCHES)
    model = TP.static_cost_model(depth=2, device="cpu")
    assert (fused_probe.LAUNCHES, row_gather.LAUNCHES) == before
    assert fused_probe.COST is None and row_gather.COST is None
    assert model["platform"] == "cpu" and model["depth"] == 2
    assert set(model["tiers"]) == {"flat", "chain"}
    flat, chain = model["tiers"]["flat"], model["tiers"]["chain"]
    assert flat["kernel_calls"] == {"ht_probe": 1, "row_gather": 4}
    assert chain["kernel_calls"] == {"ht_probe": 2, "row_gather": 8}
    for row in (flat, chain):
        assert row["flops"] > 0 and row["hbm_bytes"] > row["kernel_bytes"] > 0
        assert row["launches"] == {"ht_probe": 0, "row_gather": 0}
        assert row["roofline_seconds"] == TP.roofline_seconds(
            row["flops"], row["hbm_bytes"], "cpu")


def test_profiled_supervisor_lands_each_route_and_captures(tmp_path):
    tracer = TT.Tracer()
    prof = TP.DispatchProfiler(tracer=tracer, sample_every=1)
    sup = _supervisor(tracer, profiler=prof)
    rng = np.random.default_rng(20)
    tid, ts = 1, 2 * 10 ** 9
    for k in range(4):
        if k == 3:
            prof.capture_once(str(tmp_path / "cap"))
        tid = _window(sup, rng, tid, ts, (64, 64))
        ts += 10 ** 7
    for _ in range(2):
        tid = _window(sup, rng, tid, ts, (8,))
        ts += 10 ** 7
    rec = TP.profile_probe(tracer=tracer, profiler=prof, depth=2,
                           device="cpu")
    routes = {m["route"] for m in rec["dispatch_device_time"].values()
              if m["count"]}
    assert {"chain", "per_batch"} <= routes, routes
    assert all(m["p50_us"] > 0 for m in rec["dispatch_device_time"].values())
    for tier in ("flat", "chain"):
        frac = rec["roofline"][tier]["fraction"]
        assert 0.0 < frac < float("inf"), rec["roofline"]
    assert prof.samples == prof.dispatches == 6
    cap = prof.capture_result
    assert cap["ok"] and os.path.getsize(cap["path"]) > 0, cap
    assert rec["sampler"]["capture"] == cap
