"""The port's trace-catalog gate (`tigerbeetle_tpu_torch/testing/
trace_coverage.py`) on the CPU, against the JAX package's
(`tigerbeetle_tpu/testing/trace_coverage.py`).

- One run of the port's 15 scenarios (`coverage_main(device="cpu")`,
  module-scoped): rc 0, all 56 catalog events emitted, no off-catalog
  name, no emitted span or histogram event with an empty histogram.
- Each RED condition, with a cheap case: a scenario list without the
  SLO scenario leaves exactly the events only it emits dead; the
  recording tracer rejects an off-catalog name, and the gate reports
  one that reaches a tracer's emitted set; a span whose histogram stays
  empty is reported starved. Each returns 1.
- The events each scenario emits (its own tracers' union) equal the JAX
  harness's, for the scenarios whose JAX run is cheap here (the JAX
  side under this suite's 8 host devices: the kernel-engine clusters,
  ~15 s of JAX compiling, and the host-only scenarios). Chaos, router,
  partitioned and reshard, and the three that compile JAX device
  programs (commit windows ~21 s, overlap ~15 s, admission ~7 s), are
  held on the port alone: to the catalog, and each to the events it
  exists to emit.
  The mesh scenarios run on the port's logical shards: 8 for the
  routers, 2 for reshard.
- `metrics_main(device="cpu")` returns 0; the module's entry point runs
  the gate on the platform it is given (the card by default).
"""

import contextlib
import functools
import io

import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.testing import trace_coverage as JTC
from tigerbeetle_tpu_torch import constants as TC
from tigerbeetle_tpu_torch.testing import trace_coverage as TTC
from tigerbeetle_tpu_torch.trace import Event, EventKind, Tracer
from tests.port_verify import port_verify_restored  # noqa: F401

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

JAX_COMPARED = ("rebuild", "view_change", "grid_repair",
                "rollback_and_config", "bus_pair", "slo", "observatory",
                "causal_trace")
PORT_ONLY = ("chaos", "commit_windows", "router", "partitioned",
             "overlap", "reshard", "admission")
CATALOG = {e.name for e in Event}


def _name(fn) -> str:
    return fn.__name__.replace("_scenario_", "")


def _own_names(scenario, col) -> set:
    """Run one scenario on `col`; the names its own tracers emitted."""
    first = len(col.tracers)
    scenario(col)
    out: set = set()
    for t in col.tracers[first:]:
        out |= t.emitted
    return out


@pytest.fixture(scope="module")
def port_gate():
    """coverage_main over the port's 15 scenarios, once, on the CPU: its
    rc, its printed report, the collector, and each scenario's own
    emitted names."""
    was = TC.VERIFY
    own, cols = {}, []

    def recorded(fn):
        @functools.wraps(fn)
        def run(col):
            if not cols:
                cols.append(col)
            own[_name(fn)] = _own_names(fn, col)
        return run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = TTC.coverage_main(tuple(recorded(s) for s in TTC.SCENARIOS),
                               device="cpu")
    TC.set_verify(was)
    return dict(rc=rc, report=out.getvalue(), col=cols[0], own=own)


@pytest.fixture(scope="module")
def jax_names():
    """The JAX harness's scenarios whose runs are cheap here, each on a
    collector of its own: the names its tracers emitted."""
    from tigerbeetle_tpu import constants as JC

    was = JC.VERIFY
    out = {}
    for name in JAX_COMPARED:
        out[name] = _own_names(getattr(JTC, f"_scenario_{name}"),
                               JTC._Collector())
    JC.set_verify(was)
    return out


def test_the_scenarios_are_the_jax_harnesss():
    assert [_name(s) for s in TTC.SCENARIOS] == \
        [_name(s) for s in JTC.SCENARIOS]
    assert set(JAX_COMPARED) | set(PORT_ONLY) == \
        {_name(s) for s in TTC.SCENARIOS}
    assert (TTC.MESH_SHARDS, TTC.RESHARD_SHARDS) == (8, 2)


def test_the_gate_is_green_on_the_cpu(port_gate):
    """rc 0: every scenario passed, 56 of 56 events, none off-catalog,
    no starved histogram (the gate's own checks, recomputed here)."""
    assert port_gate["rc"] == 0, port_gate["report"]
    col = port_gate["col"]
    emitted = col.emitted()
    assert len(CATALOG) == 56 and emitted == CATALOG
    assert "[trace-cov] 56/56 catalog events emitted" in port_gate["report"]
    assert "FAILED" not in port_gate["report"]
    assert "RED" not in port_gate["report"]
    fed: dict = {}
    for t in col.tracers:
        for key, h in t.histograms.items():
            name = t.histogram_series[key][0]
            fed[name] = fed.get(name, 0) + h.count
    for e in Event:
        if e.kind in (EventKind.span, EventKind.histogram):
            assert fed.get(e.name), e.name
    assert len(port_gate["own"]) == 15


@pytest.mark.parametrize("name", PORT_ONLY)
def test_the_costly_scenarios_emit_on_the_port(port_gate, name):
    """The scenarios whose JAX runs are not compared: on-catalog, and
    each emits the events it exists to prove."""
    own = port_gate["own"][name]
    assert own and own <= CATALOG
    want = {"chaos": {"serving_recoveries", "serving_retries",
                      "serving_recovery_replay", "serving_epoch_verify",
                      "flight_recorder_dump", "window_commit"},
            "commit_windows": {"commit_windows", "commit_execute"},
            "overlap": {"window_stage", "host_stall_fraction"},
            "admission": {"admission_decision", "admission_shed",
                          "admission_credit_occupancy", "trace_tail_keep",
                          "window_commit"},
            "router": {"router_step", "router_reroute", "router_fallback"},
            "partitioned": {"shard_exchange", "cross_shard_transfers",
                            "device_fixpoint_rounds", "device_poison_cause",
                            "device_exchange_occupancy",
                            "device_ring_occupancy",
                            "device_writeback_rows"},
            "reshard": {"reshard_stage", "reshard_rows_copied",
                        "reshard_overlay_active"}}[name]
    assert want <= own, sorted(want - own)


@pytest.mark.parametrize("name", JAX_COMPARED)
def test_a_scenario_emits_the_jax_harnesss_events(port_gate, jax_names,
                                                   name):
    assert port_gate["own"][name] == jax_names[name]


def _replay(names):
    """A scenario that emits each of `names` once on a fresh tracer."""
    def replay(col):
        t = col.make(0)
        for e in Event:
            if e.name not in names:
                continue
            if e.kind is EventKind.span:
                t.record_span(e, t.now_ns(), 1000)
            elif e.kind is EventKind.counter:
                t.count(e)
            elif e.kind is EventKind.gauge:
                t.gauge(e, 1.0)
            else:
                t.observe(e, 1.0)
    return replay


def test_a_list_without_the_slo_scenario_leaves_its_events_dead(
        port_gate, capsys):
    """The other 14 scenarios' events, replayed: exactly the events only
    the SLO scenario emits are dead, and the gate is red."""
    own = port_gate["own"]
    others = set().union(*(v for k, v in own.items() if k != "slo"))
    only_slo = sorted(own["slo"] - others)
    assert only_slo == ["slo_breach"]
    assert TTC.coverage_main((_replay(others),), device="cpu") == 1
    out = capsys.readouterr().out
    assert f"RED: dead catalog events (never emitted by the smokes): " \
        f"{only_slo}" in out
    # The whole catalog replayed is green.
    assert TTC.coverage_main((_replay(CATALOG),), device="cpu") == 0


def test_an_off_catalog_name_is_red():
    t = Tracer(pid=0)
    with pytest.raises(KeyError, match="not in the catalog"):
        t.count("not_an_event")
    with pytest.raises(KeyError, match="not in the catalog"):
        t.record_span("not_a_span", t.now_ns(), 1)

    def smuggled(col):
        _replay(CATALOG)(col)
        col.tracers[-1].emitted.add("not_an_event")

    assert TTC.coverage_main((smuggled,), device="cpu") == 1


def test_a_span_with_an_empty_histogram_is_starved(capsys):
    def broken(col):
        _replay(CATALOG)(col)
        t = col.tracers[-1]
        for key in [k for k in t.histograms
                    if t.histogram_series[k][0] == "window_commit"]:
            del t.histograms[key]

    assert TTC.coverage_main((broken,), device="cpu") == 1
    out = capsys.readouterr().out
    assert "RED: emitted events with EMPTY histograms (span-close " \
        "accumulation broken): ['window_commit']" in out


def test_a_failing_scenario_is_red(capsys):
    def fails(col):
        raise AssertionError("boom")

    assert TTC.coverage_main((_replay(CATALOG), fails), device="cpu") == 1
    assert "fails FAILED: AssertionError('boom')" in capsys.readouterr().out


def test_metrics_main_is_green_on_the_cpu():
    was = TC.VERIFY
    assert TTC.metrics_main(device="cpu") == 0
    assert TC.VERIFY == was


def test_the_entry_point_passes_the_platform_on(monkeypatch):
    calls = []
    monkeypatch.setattr(TTC, "coverage_main",
                        lambda **kw: calls.append(kw) or len(calls) - 1)
    assert TTC.main(["--platform", "cpu"]) == 0
    assert TTC.main([]) == 1
    assert calls == [{"device": "cpu"}, {"device": "cuda"}]
