"""The port's causality leg (`testing/causality_smoke.py`) and its trace
merge (`trace/merge.py`) against the JAX package's, on the CPU.

Seeded synthetic Chrome documents (numpy `default_rng`): N requests
traced from a client (pid 99) through three replicas, each pid's clock
skewed, every frame a matched bus_send / bus_recv pair, a commit window
linked to its requests across the batching boundary, and one defect a
document (an orphan span, a missing commit_execute, a wrong root, a
stray trace, an empty critical path). On each, the leg's predicate and
negative-proof mutations and every function of `trace/merge.py` equal
the JAX package's exactly, as Python objects.

Then one live run of the leg, shared by the module: `causality_main`
on the port's own 3-replica vortex over TCP with `platform="cpu"` (the
oracle engine: no kernel runs). It must be green with both negative
proofs red; the documents its merge and assembly saw are recorded as
they are called, and the JAX package's assembler and predicate must
give the port's verdict on each. The replicas' own merged trace
(`VortexSupervisor.collect_merged_trace`) is one monotone timeline of
replicas 0, 1 and 2.
"""

import contextlib
import io
import json

import numpy as np
import pytest

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu import trace as JTR
from tigerbeetle_tpu.testing import causality_smoke as JCS
from tigerbeetle_tpu_torch import trace as PTR
from tigerbeetle_tpu_torch.testing import causality_smoke as PCS
from tigerbeetle_tpu_torch.testing import vortex as PV
from tigerbeetle_tpu_torch.trace.histogram import Histogram

ROOT = "0" * 16
REPLICAS = (0, 1, 2)
COMMIT = ("commit_prefetch", "commit_execute", "commit_compact")
# (seed, defect): one document each; the defect's problem, or None.
CASES = {
    "clean": (3, None),
    "orphan": (5, "orphan spans"),
    "no_commit": (7, "commit never causally attributed"),
    "wrong_root": (11, "not client_request"),
    "stray_trace": (13, "traces, assembled"),
    "empty_path": (17, "empty critical path"),
}


def _copy(doc):
    return json.loads(json.dumps(doc))


def _raw_docs(seed: int, defect: str) -> tuple:
    """(one Chrome document a pid: replicas 0-2 and the client 99, the
    number of requests), with the defect of the case named `defect`.
    Every event's ts is its true time plus its pid's skew; every frame
    is a bus_send on its sender and a bus_recv on its receiver with the
    same csum."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 7))
    pids = REPLICAS + (PCS.CLIENT_PID,)
    skew = {p: (0.0 if p == 0 else round(float(rng.uniform(-3e3, 3e3)), 3))
            for p in pids}
    events = {p: [] for p in pids}
    kept = {}

    def sid():
        return rng.bytes(8).hex()

    def span(pid, name, t, dur, tid=None, parent=None, span_id=None,
             **args):
        if tid is not None:
            args.update(trace_id=tid, span_id=span_id or sid(),
                        parent_id=parent)
        e = {"name": name, "ph": "X", "pid": pid, "tid": 1,
             "ts": round(t + skew[pid], 3), "dur": round(dur, 3),
             "args": args}
        events[pid].append(e)
        return args.get("span_id")

    def frame(src, dst, t, tid, parent_src, parent_dst):
        """A frame src -> dst sent at t: its two spans; returns the
        receive's span id and its end."""
        csum = int(rng.integers(1, 2 ** 62))
        send = float(rng.uniform(2, 9))
        wire = float(rng.uniform(20, 90))
        span(src, "bus_send", t, send, tid, parent_src, csum=csum)
        got = sid()
        recv = float(rng.uniform(2, 9))
        span(dst, "bus_recv", t + send + wire, recv, tid, parent_dst,
             span_id=got, csum=csum)
        return got, t + send + wire + recv

    tids = []
    for k in range(n):
        tid = rng.bytes(16).hex()
        tids.append(tid)
        t = 1e3 + 8e3 * k + float(rng.uniform(0, 500))
        root = sid()
        at_primary, t1 = frame(99, 0, t + 5, tid, root, root)
        op = k + 1
        for r in REPLICAS:
            start = t1 + (0.0 if r == 0 else float(rng.uniform(150, 400)))
            parent = at_primary
            if r:
                parent, start = frame(0, r, t1 + 10, tid, at_primary,
                                      at_primary)
            for stage in COMMIT:
                if stage == "commit_execute" and defect == "no_commit" \
                        and k == 2:
                    start += 10
                    continue
                dur = float(rng.uniform(40, 300))
                p = parent
                if defect == "orphan" and k == 1 and r == 2 \
                        and stage == "commit_compact":
                    p = sid()
                span(r, stage, start, dur, tid, p, op=op)
                start += dur + float(rng.uniform(1, 10))
            if r:
                frame(r, 0, start, tid, parent, at_primary)
        quorum = float(rng.uniform(100, 600))
        span(0, "commit_quorum", t1 + 5, quorum, tid, at_primary)
        _, end = frame(0, 99, t1 + 900, tid, at_primary, root)
        name = ("request_replay" if defect == "wrong_root" and k == 0
                else "client_request")
        dur = 0.0 if defect == "empty_path" and k == 3 else end - t + 20
        span(99, name, t, dur, tid, ROOT, span_id=root,
             operation=138 if k else 137)
        if rng.random() < 0.4:
            kept[tid] = "slow"
    # A commit window serving two requests: linked, not parented.
    lt = sorted(tids[:2])
    span(0, "window_commit", 5e2, float(rng.uniform(50, 200)), links=lt)
    span(0, "serving_dispatch", 6e2, float(rng.uniform(10, 40)), links=lt)
    if defect == "stray_trace":
        span(99, "client_request", 9e4, 100.0, rng.bytes(16).hex(), ROOT)
    docs = []
    for p in pids:
        h = Histogram()
        h.record_many(rng.uniform(0.1, 9.0, size=int(rng.integers(1, 9))))
        meta = {"pid": p,
                "clock_anchor_ns": int(rng.integers(1, 2 ** 60)),
                "dropped_events": int(rng.integers(0, 3)),
                "kept_traces": kept if p == 99 else {},
                "exemplars": {"commit_execute|": {
                    "value": float(rng.uniform(1, 9)), "trace_id": tids[0]}},
                "histograms": {"commit_execute|": {
                    "event": "commit_execute", "tags": {}, **h.to_dict()}}}
        evs = [{"name": "process_name", "ph": "M", "pid": p, "tid": 0,
                "args": {"name": f"replica {p}"}}] + events[p]
        rng.shuffle(evs)
        docs.append({"traceEvents": evs, "metadata": meta})
    return docs, n


@pytest.fixture(scope="module")
def docs():
    """case -> (the raw documents, the merged document, n)."""
    out = {}
    for case, (seed, _) in CASES.items():
        raw, n = _raw_docs(seed, case)
        out[case] = (raw, PTR.merge_traces(_copy(raw)), n)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_check_and_strips_equal_the_jax_packages(case, docs):
    """The leg's predicate on the assembled document, and on both of its
    negative-proof mutations, equals the JAX leg's; each defect reds
    with its own problem, the clean document is green, and every
    mutation reds."""
    _, merged, n = docs[case]
    want = CASES[case][1]
    got = PCS._check_assembly(PTR.assemble_traces(_copy(merged)), n)
    assert got == JCS._check_assembly(JTR.assemble_traces(_copy(merged)), n)
    if want is None:
        assert got == []
    else:
        assert got and any(want in p for p in got), got
    for p_strip, j_strip in ((PCS._strip_headers, JCS._strip_headers),
                             (PCS._strip_roots, JCS._strip_roots)):
        stripped = p_strip(_copy(merged))
        assert stripped == j_strip(_copy(merged))
        bad = PCS._check_assembly(PTR.assemble_traces(stripped, 1.0), n)
        assert bad and bad == JCS._check_assembly(
            JTR.assemble_traces(_copy(stripped), 1.0), n)
    assert (PCS.CLIENT_PID, PCS.REQUESTS) == (JCS.CLIENT_PID, JCS.REQUESTS)


@pytest.mark.parametrize("case", list(CASES))
def test_merge_functions_equal_the_jax_packages(case, docs):
    """Every function of trace/merge.py equals the JAX package's on the
    document: the merge with and without the rebase, the clock offsets
    (every replica and the client measured), the assembly at two head
    rates and without skew correction, each trace's causal edges, the
    critical path, and the span quantiles."""
    raw, merged, _ = docs[case]
    for rebase in (True, False):
        got = PTR.merge_traces(_copy(raw), rebase=rebase)
        assert got == JTR.merge_traces(_copy(raw), rebase=rebase)
    assert got["metadata"]["replicas"] == [0, 1, 2, PCS.CLIENT_PID]
    offsets = PTR.estimate_clock_offsets(merged)
    assert offsets == JTR.estimate_clock_offsets(_copy(merged))
    assert sorted(offsets) == [0, 1, 2, PCS.CLIENT_PID]
    for kw in (dict(head_rate=1.0), dict(head_rate=0.5, seed=3),
               dict(skew_correct=False)):
        asm = PTR.assemble_traces(merged, **kw)
        assert asm == JTR.assemble_traces(_copy(merged), **kw)
    asm = PTR.assemble_traces(merged)
    edges = [PTR.causal_edges(t) for t in asm["traces"]]
    assert edges == [JTR.causal_edges(t) for t in
                     JTR.assemble_traces(_copy(merged))["traces"]]
    assert sum(map(len, edges)) > 0
    for q in (0.5, 0.9, 1.0):
        cp = PTR.critical_path(merged, quantile=q)
        assert cp == JTR.critical_path(_copy(merged), quantile=q)
        assert cp["window_event"] == "window_commit"
        assert PTR.critical_path(merged, q, "nothing") == JTR.critical_path(
            _copy(merged), q, "nothing")
        for name, tag in (("commit_execute", "op"), ("bus_recv", None),
                          ("client_request", "operation")):
            assert PTR.span_quantile(merged, name, q, tag) == \
                JTR.span_quantile(_copy(merged), name, q, tag)
    assert PTR.CRITICAL_PATH_STAGES == JTR.CRITICAL_PATH_STAGES


@pytest.mark.parametrize("case", ["clean", "stray_trace"])
def test_merge_trace_files_equals_the_jax_packages(case, docs, tmp_path):
    """The file merge returns and writes the JAX package's document."""
    raw = docs[case][0]
    paths = []
    for i, d in enumerate(raw):
        paths.append(str(tmp_path / f"r{i}.trace.json"))
        with open(paths[-1], "w") as f:
            json.dump(d, f)
    got = PTR.merge_trace_files(paths, str(tmp_path / "p.json"))
    want = JTR.merge_trace_files(paths, str(tmp_path / "j.json"))
    assert got == want
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert PTR.merge_trace_files(paths) == got


# ------------------------------------------------------------ live run

@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """One `causality_main(platform="cpu")` on the port's vortex, its
    printed lines, every document its merge and assembly saw (recorded as
    they are called; the calls go through), and the replicas' own merged
    trace file, written by `collect_merged_trace` after the shutdown."""
    out = tmp_path_factory.mktemp("causality")
    merges, assemblies = [], []
    shutdown = PV.VortexSupervisor.shutdown

    def merge(docs, *a, _fn=PTR.merge_traces, **k):
        merges.append(_copy(docs))
        return _fn(docs, *a, **k)

    def assemble(doc, *a, _fn=PTR.assemble_traces, **k):
        res = _fn(doc, *a, **k)
        assemblies.append((_copy(doc), a, k, res))
        return res

    def stop(self):
        shutdown(self)
        self.collect_merged_trace(str(out / "cluster.trace.json"))

    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PTR, "merge_traces", merge)
        mp.setattr(PTR, "assemble_traces", assemble)
        mp.setattr(PV.VortexSupervisor, "shutdown", stop)
        with contextlib.redirect_stdout(printed):
            rc = PCS.causality_main(platform="cpu")
    return dict(rc=rc, lines=printed.getvalue().splitlines(),
                merges=merges, assemblies=assemblies,
                cluster=json.loads((out / "cluster.trace.json").read_text()))


def test_causality_leg_is_green_on_the_ports_vortex(live):
    """Six requests assemble into six complete trees, each rooted at
    client_request with commit_execute inside and no orphan, and both
    negative proofs red."""
    assert live["rc"] == 0, live["lines"]
    assert not [ln for ln in live["lines"] if "RED" in ln]
    assert any(ln.startswith("[causality] 6 requests -> 6 complete trees, "
                             "0 orphans") for ln in live["lines"])
    for label in ("dropped-header", "dropped-root"):
        assert f"[causality] negative proof ok: {label} detected" in \
            live["lines"]
    (docs,) = live["merges"]
    assert sorted(d["metadata"]["pid"] for d in docs) == [
        0, 1, 2, PCS.CLIENT_PID]
    asm = live["assemblies"][0][3]
    assert (asm["total"], asm["complete"], asm["orphan_spans"]) == (6, 6, 0)
    for t in asm["traces"]:
        assert t["root"]["name"] == "client_request"
        assert "commit_execute" in {s["name"] for s in t["spans"]}
        assert t["critical_path"]["total_us"] > 0
    assert sorted(asm["clock_offsets_us"]) == ["0", "1", "2",
                                               str(PCS.CLIENT_PID)]


def test_the_jax_assembler_gives_the_ports_verdict(live):
    """The merged document of the run, and both of its stripped
    variants, assemble in the JAX package into what the port assembled,
    and the JAX leg's predicate gives the port's problems: none on the
    run, some on each variant."""
    merged, mutations = live["assemblies"][0][0], (JCS._strip_headers,
                                                   JCS._strip_roots)
    assert len(live["assemblies"]) == 3
    for i, (doc, a, k, got) in enumerate(live["assemblies"]):
        if i:
            assert doc == mutations[i - 1](_copy(merged))
        want = JTR.assemble_traces(_copy(doc), *a, **k)
        assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
        problems = PCS._check_assembly(got, PCS.REQUESTS)
        assert problems == JCS._check_assembly(want, JCS.REQUESTS)
        assert bool(problems) == bool(i)
    assert live["assemblies"][0][0] == _copy(JTR.merge_traces(
        _copy(live["merges"][0])))


def test_merged_vortex_trace_is_one_monotone_timeline(live):
    """The replicas' dumped traces merge (`collect_merged_trace`) into
    one document of replicas 0, 1 and 2 on a monotone timeline, each
    replica's commit stages in it; the leg's merge adds the client's
    pid on the same monotone timeline."""
    leg = live["assemblies"][0][0]
    assert leg["metadata"]["replicas"] == [0, 1, 2, PCS.CLIENT_PID]
    doc = live["cluster"]
    assert doc["metadata"]["replicas"] == [0, 1, 2]
    for d in (leg, doc):
        ts = [e["ts"] for e in d["traceEvents"] if e.get("ph") != "M"]
        assert ts and ts == sorted(ts), "merged timeline is not monotone"
    timed = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    for pid in REPLICAS:
        names = {e["name"] for e in timed if e["pid"] == pid}
        assert set(COMMIT) <= names, (pid, sorted(names))
    assert doc == _copy(JTR.merge_traces(
        [d for d in live["merges"][0]
         if d["metadata"]["pid"] != PCS.CLIENT_PID]))
