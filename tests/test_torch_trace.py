"""The port's trace core (`tigerbeetle_tpu_torch/trace/`) against the JAX
package's (`tigerbeetle_tpu/trace/`), on the same inputs: the event
catalog, histograms, trace contexts, the flight recorder and the
recording tracer must agree, so traces from both packages merge. Pure
host code: no device, no JAX program."""

import json
import random

import numpy as np
import pytest

from tigerbeetle_tpu import trace as JT
from tigerbeetle_tpu.trace import flight_recorder as JFR
from tigerbeetle_tpu.trace import histogram as JH
from tigerbeetle_tpu_torch import trace as TT
from tigerbeetle_tpu_torch.trace import histogram as TH

SEEDS = (1, 7, 23)


def _spec(ev):
    return (ev.name, ev.kind.value, ev.tags, ev.slots, ev.hist_tags,
            ev.doc)


def test_event_catalog_equals_the_jax_packages():
    """Same members, in the same order, with the same kind, tags, lanes,
    histogram tags and doc; the same Chrome lanes."""
    assert [_spec(e) for e in TT.Event] == [_spec(e) for e in JT.Event]
    assert list(TT.CATALOG) == list(JT.CATALOG)
    assert ({e.name: v for e, v in TT.TID_BASE.items()}
            == {e.name: v for e, v in JT.TID_BASE.items()})
    for e in TT.Event:
        assert TT.lookup(e.name) is e
    with pytest.raises(KeyError):
        TT.lookup("not_an_event")


def _values(seed, n=500):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(3.0, 2.0, n), [0.0, 1e-9, 1e12]])


@pytest.mark.parametrize("seed", SEEDS)
def test_histogram_matches(seed):
    """Buckets, quantiles, summary, to_dict/from_dict and merge on seeded
    values, one at a time and in bulk."""
    vals = _values(seed)
    hs = []
    for mod in (TH, JH):
        h, bulk = mod.Histogram(), mod.Histogram()
        for v in vals[:200]:
            h.record(float(v))
        bulk.record_many(vals[200:])
        h.merge(bulk)
        back = mod.Histogram.from_dict(h.to_dict())
        hs.append((h.to_dict(), h.summary(), h.cumulative(),
                   [h.quantile(q) for q in (0, 0.5, 0.9, 0.99, 0.999, 1)],
                   back.to_dict(),
                   mod.Histogram.merged([h, back]).to_dict()))
    assert hs[0] == hs[1]
    assert all(TH.bucket_index(float(v)) == JH.bucket_index(float(v))
               for v in vals if v > 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_context_matches(seed):
    """pack/unpack, the id formats, minting and head sampling."""
    rng = random.Random(seed)
    for _ in range(50):
        client, req = rng.randrange(1 << 40), rng.randrange(1 << 20)
        rate = rng.random()
        t_ctx = TT.mint_context(client, req, head_rate=rate, seed=seed)
        j_ctx = JT.mint_context(client, req, head_rate=rate, seed=seed)
        assert (t_ctx.trace_id, t_ctx.parent_span_id, t_ctx.flags) == (
            j_ctx.trace_id, j_ctx.parent_span_id, j_ctx.flags)
        assert t_ctx.pack() == j_ctx.pack()
        child = t_ctx.child(rng.randrange(1, 1 << 63))
        back = TT.TraceContext.unpack(child.pack())
        j_back = JT.TraceContext.unpack(child.pack())
        assert (back.trace_id, back.parent_span_id, back.flags) == (
            j_back.trace_id, j_back.parent_span_id, j_back.flags)
        tid = TT.mint_trace_id(client, req, seed)
        assert tid == JT.mint_trace_id(client, req, seed)
        assert TT.fmt_trace_id(tid) == JT.fmt_trace_id(tid)
        assert TT.fmt_span_id(req) == JT.fmt_span_id(req)
        assert TT.head_sampled(tid, rate, seed) == JT.head_sampled(
            tid, rate, seed)
    garbage = bytes(rng.randrange(256) for _ in range(28))
    assert (TT.TraceContext.unpack(garbage) is None) == (
        JT.TraceContext.unpack(garbage) is None)


def _fill_recorder(rec, seed):
    rng = random.Random(seed)
    for w in range(100):
        kw = {}
        if w % 3 == 0:
            kw["telemetry"] = {
                "fix_rounds": [rng.randrange(0, 32) for _ in range(4)],
                "exchange_occupancy_pct": [rng.random() * 100]}
        if w % 7 == 0:
            kw["epoch_digest"] = {"accounts_u64": rng.randrange(1 << 64)}
        if w % 5 == 0:
            kw["trace_ids"] = [f"{rng.randrange(1 << 64):032x}"]
        rec.record(window=w, route=rng.choice(("chain", "super_deep")),
                   prepares=rng.randrange(1, 9), **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_flight_recorder_matches(seed, tmp_path):
    """The bounded ring, to_dict, the dump (into a directory given by
    argument, the port's; the JAX recorder's `out_dir`) and the lossless
    merge of several recorders' dumps."""
    t_dir, j_dir = tmp_path / "port", tmp_path / "jax"
    t_tracer, j_tracer = TT.Tracer(pid=1), JT.Tracer(pid=1)
    t_rec = TT.FlightRecorder(capacity=32, pid=1, tracer=t_tracer,
                              dump_dir=str(t_dir))
    j_rec = JT.FlightRecorder(capacity=32, pid=1, tracer=j_tracer,
                              out_dir=str(j_dir))
    _fill_recorder(t_rec, seed)
    _fill_recorder(j_rec, seed)
    assert t_rec.to_dict() == j_rec.to_dict()
    assert len(t_rec.records) == 32 and t_rec.seq == 100
    t_path = t_rec.dump("state_digest")
    j_path = j_rec.dump("state_digest")
    assert t_path.startswith(str(t_dir))
    assert (t_path.rsplit("/", 1)[1] == j_path.rsplit("/", 1)[1]
            == "FLIGHT_1_state_digest_000100.json")
    with open(t_path) as f, open(j_path) as g:
        assert json.load(f) == json.load(g)
    assert t_tracer.counters == j_tracer.counters == {
        "flight_recorder_dump": 1}
    # A second replica's dump, merged with the first.
    t_two = TT.FlightRecorder(pid=2, dump_dir=str(t_dir))
    j_two = JT.FlightRecorder(pid=2, out_dir=str(j_dir))
    _fill_recorder(t_two, seed + 1)
    _fill_recorder(j_two, seed + 1)
    t_docs = [t_path, t_two.dump("drain_fault")]
    j_docs = [j_path, j_two.dump("drain_fault")]
    assert (TT.merge_flight_records(t_docs)
            == JT.merge_flight_records(j_docs))
    assert (TT.merge_flight_records([t_rec.to_dict(), t_two.to_dict()])
            == JFR.merge_flight_records([j_rec.to_dict(), j_two.to_dict()]))


def test_flight_recorder_reads_no_environment(tmp_path, monkeypatch):
    """The port's dump directory is the argument or <tempdir>/tb_tpu_flight,
    never an environment variable."""
    import tempfile

    (tmp_path / "tmp").mkdir()
    monkeypatch.setenv("TB_TPU_FLIGHT_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setattr(tempfile, "tempdir", None)
    path = TT.FlightRecorder().dump("x")
    assert path.startswith(str(tmp_path / "tmp" / "tb_tpu_flight"))
    assert not (tmp_path / "env").exists()


def _drive(mod, seed):
    """The same calls on a recording tracer of `mod`."""
    rng = random.Random(seed)
    tr = mod.Tracer(pid=3, capacity=64)
    E = mod.Event
    ctx = mod.mint_context(9, 1, head_rate=1.0, seed=seed)
    for i in range(40):
        with tr.span(E.serving_dispatch, what="window"):
            pass
        with tr.span(E.window_commit, ctx=ctx if i % 4 == 0 else None) as sp:
            sp.link(f"{rng.randrange(1 << 64):032x}")
            sp.tags["route"] = rng.choice(("chain", "super_deep"))
            sp.tags["tier"] = "scan"
        tr.record_span(E.window_stage, 1000 * i, 500 + i, mode="inline",
                       route="chain")
        tr.record_span(E.admission_decision, 2000 * i, 100, ctx=ctx,
                       decision="admit", cls="critical")
        tr.count(E.dispatch_route, route="chain")
        tr.gauge(E.host_stall_fraction, rng.random())
        tr.observe(E.serving_replay_windows, rng.randrange(0, 8))
        if i % 9 == 0:
            tr.keep_trace(mod.fmt_trace_id(ctx.trace_id), reason="fallback")
            tr.count(E.serving_recoveries, cause="state_digest")
    with pytest.raises(ValueError):
        tr.count(E.window_commit)          # a span used as a counter
    with pytest.raises(ValueError):
        tr.count(E.serving_retries, bogus=1)   # a tag off the schema
    return tr


def _shape(doc):
    """A chrome document with the clocks taken out: every event's name,
    phase, lane and args, and the metadata but the clock anchor and the
    duration sums."""
    events = [(e["name"], e["ph"], e.get("tid"),
               {k: v for k, v in (e.get("args") or {}).items()})
              for e in doc["traceEvents"]]
    meta = dict(doc["metadata"])
    meta.pop("clock_anchor_ns")
    meta.pop("aggregates")
    meta["exemplars"] = sorted(meta["exemplars"])
    meta["histograms"] = {k: (v["event"], v["tags"], v["count"])
                          for k, v in meta["histograms"].items()}
    return events, meta


@pytest.mark.parametrize("seed", SEEDS)
def test_tracer_chrome_trace_matches(seed):
    """The same calls give the same chrome events (names, lanes, tags,
    causal ids, links), counters, gauges, kept traces and histogram
    series on both tracers, the ring's eviction marker included; the
    null tracers accept the same calls."""
    t_tr, j_tr = _drive(TT, seed), _drive(JT, seed)
    assert _shape(t_tr.chrome_dict()) == _shape(j_tr.chrome_dict())
    assert t_tr.dropped_events == j_tr.dropped_events > 0
    assert t_tr.emitted == j_tr.emitted
    for tr in (TT.NullTracer(), JT.NullTracer()):
        with tr.span(TT.Event.window_commit) as sp:
            sp.link("00")
            sp.tags["route"] = "chain"
        assert tr.now_ns() == 0


def test_timing_aggregates_match():
    """The StatsD-side aggregates over the same samples."""
    from tigerbeetle_tpu.trace import statsd as JS
    from tigerbeetle_tpu_torch.trace import statsd as TS

    rng = random.Random(5)
    samples = [(rng.choice(("a", "b")), rng.random() * 1e3,
                {"route": rng.choice(("chain", "flat"))}) for _ in range(300)]
    snaps = []
    for mod in (TS, JS):
        agg = mod.TimingAggregates()
        for name, us, tags in samples:
            agg.record(name, us, tags)
        snaps.append(agg.snapshot())
    assert snaps[0] == snaps[1]
