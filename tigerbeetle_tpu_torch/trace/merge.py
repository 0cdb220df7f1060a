"""Cluster-wide trace merge: one Perfetto timeline from N replica traces.

The per-replica Chrome traces are already cross-process comparable: each
recording tracer anchors its span timestamps to the wall clock at
construction (trace/tracer.py `clock_anchor_ns`), so merging is
concatenation + a common rebase — no clock inference. `pid` identifies
the replica (set at tracer construction: `--trace` uses the replica id),
so one Perfetto load shows the whole cluster's commit/repair/rebuild
timeline with one process track per replica.

A copy of the JAX package's `trace/merge.py`. Used by testing/cluster.py
(in-process clusters merge their replicas' tracers directly); servers
started with `--trace` dump their files on shutdown, which
`merge_trace_files` merges.
"""

from __future__ import annotations

import json
import math
from typing import Optional

from .histogram import Histogram


def merge_traces(docs: list, rebase: bool = True) -> dict:
    """Merge Chrome-trace documents (as produced by
    Tracer.chrome_dict / dump_chrome_trace) into one.

    Replica identity must survive: documents with colliding pids are
    renumbered (their metadata events follow). With rebase=True every
    timed event is shifted so the earliest one lands at ts=0 — the
    common epoch-aligned base a multi-gigasecond wall-clock ts would
    otherwise bury."""
    events: list[dict] = []
    seen_pids: set = set()
    anchors: dict = {}
    dropped = 0
    histograms: dict = {}
    kept_traces: dict = {}
    exemplars: dict = {}
    for doc in docs:
        meta = doc.get("metadata", {})
        pid = meta.get("pid", 0)
        while pid in seen_pids:
            pid += 1  # collision: renumber deterministically
        seen_pids.add(pid)
        anchors[pid] = meta.get("clock_anchor_ns")
        dropped += meta.get("dropped_events", 0)
        # Tail retention is cluster-wide: a trace ANY pid flagged stays
        # kept in the merged document; exemplars keep the largest value
        # per series (the one a p99 bucket most plausibly links to).
        for tid, reason in (meta.get("kept_traces") or {}).items():
            kept_traces.setdefault(tid, reason)
        for key, ex in (meta.get("exemplars") or {}).items():
            cur = exemplars.get(key)
            if cur is None or ex.get("value", 0) > cur.get("value", 0):
                exemplars[key] = dict(ex)
        # Cluster-wide distributions: per-replica histograms with the
        # same series key ADD losslessly (integer bucket counts) — the
        # property the merged p99s in the acceptance check lean on.
        for key, d in (meta.get("histograms") or {}).items():
            h = Histogram.from_dict(d)
            if key in histograms:
                histograms[key]["_h"].merge(h)
            else:
                histograms[key] = {"event": d.get("event"),
                                   "tags": d.get("tags", {}), "_h": h}
        for e in doc.get("traceEvents", []):
            e = dict(e)
            e["pid"] = pid
            events.append(e)
    timed = [e for e in events if e.get("ph") != "M"]
    if rebase and timed:
        t0 = min(e["ts"] for e in timed)
        for e in timed:
            e["ts"] = round(e["ts"] - t0, 3)
    # Metadata first, then time order — Perfetto wants names early and
    # the acceptance checker wants a monotone stream.
    events.sort(key=lambda e: (0, 0) if e.get("ph") == "M"
                else (1, e["ts"]))
    return {
        "traceEvents": events,
        "metadata": {
            "replicas": sorted(seen_pids),
            "clock_anchors_ns": anchors,
            "dropped_events": dropped,
            "kept_traces": kept_traces,
            "exemplars": exemplars,
            "histograms": {
                key: {"event": v["event"], "tags": v["tags"],
                      **v["_h"].to_dict()}
                for key, v in histograms.items()},
        },
    }


def span_quantile(doc: dict, name: str, q: float,
                  tag: Optional[str] = None) -> dict:
    """Exact nearest-rank quantile(s) of a span event's durations in a
    (merged) trace document, in MILLISECONDS. With `tag` the durations
    are grouped by that span-arg value ({tag_value: quantile_ms}); the
    "" key aggregates everything. The offline ground truth the endpoint
    histograms are checked against (within the histogram error bound)."""
    groups: dict = {"": []}
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("name") != name:
            continue
        dur_ms = e.get("dur", 0.0) / 1000.0
        groups[""].append(dur_ms)
        if tag is not None:
            v = (e.get("args") or {}).get(tag)
            if v is not None:
                groups.setdefault(str(v), []).append(dur_ms)
    out = {}
    for k, durs in groups.items():
        if not durs:
            continue
        durs.sort()
        out[k] = durs[max(0, math.ceil(q * len(durs)) - 1)]
    return out


# The stage events a window's wall time is attributed to, in display
# order; "dispatch_retry" is the serving_dispatch span's backoff +
# retried attempts, visible as dispatch wall time beyond the window's
# own execute share.
CRITICAL_PATH_STAGES = (
    "admission_decision", "commit_prefetch", "commit_execute",
    "commit_compact", "commit_checkpoint", "journal_write",
    "serving_dispatch", "serving_epoch_verify",
    "serving_recovery_replay",
)


def critical_path(doc: dict, quantile: float = 0.9,
                  window_event: str = "window_commit") -> Optional[dict]:
    """Stage-share attribution for the slowest windows of a (merged)
    trace: which stage owns the tail.

    Walks the spans of the slowest-``(1-quantile)`` fraction of windows
    (default: the slowest decile). A "window" is a `window_event` span
    when the trace has any (serving traces); otherwise each replica's
    per-op commit group (commit_* spans sharing an `op` arg — replica
    traces, where the end-to-end unit is one committed prepare). Each
    selected window's wall time is attributed to the stage spans
    overlapping its [ts, ts+dur] interval on the same pid; time no
    stage claims is "other". Returns None when the trace has neither
    window spans nor commit groups."""
    spans = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in spans if e.get("name") == window_event]
    synthesized = False
    if not windows:
        windows = _commit_groups(spans)
        synthesized = True
    if not windows:
        return None
    windows.sort(key=lambda e: e["dur"])
    cut = int(len(windows) * quantile)
    slow = windows[cut:] or windows[-1:]
    stage_us: dict = {}
    other_us = 0.0
    total_us = 0.0
    for w in slow:
        t0, t1 = w["ts"], w["ts"] + w["dur"]
        total_us += w["dur"]
        claimed = 0.0
        # A synthesized window IS its commit_* members: attribute only
        # the group's own spans, not an interleaved neighbor op's.
        candidates = w["_members"] if synthesized else spans
        for s in candidates:
            if (s is w or s.get("pid") != w.get("pid")
                    or s.get("name") not in CRITICAL_PATH_STAGES):
                continue
            overlap = min(t1, s["ts"] + s["dur"]) - max(t0, s["ts"])
            if overlap > 0:
                name = s["name"]
                stage_us[name] = stage_us.get(name, 0.0) + overlap
                claimed += overlap
        other_us += max(0.0, w["dur"] - claimed)
    if other_us > 1e-9:
        stage_us["other"] = other_us
    denom = sum(stage_us.values()) or 1.0
    shares = {k: round(v / denom, 4)
              for k, v in sorted(stage_us.items(),
                                 key=lambda kv: -kv[1])}
    durs = sorted(e["dur"] for e in windows)
    p99_us = durs[max(0, math.ceil(0.99 * len(durs)) - 1)]
    return {
        "window_event": window_event if not synthesized else "commit_op",
        "windows_total": len(windows),
        "windows_analyzed": len(slow),
        "slow_quantile": quantile,
        "threshold_ms": round(slow[0]["dur"] / 1000.0, 3),
        "p99_ms": round(p99_us / 1000.0, 3),
        "stage_share": shares,
        "p99_owner": next(iter(shares), None),
    }


def _commit_groups(spans: list) -> list:
    """Synthesize window intervals from replica commit pipelines: the
    commit_* spans sharing one (pid, op) form a group whose envelope
    [first start, last end] is the per-op window."""
    groups: dict = {}
    for s in spans:
        if not str(s.get("name", "")).startswith("commit_"):
            continue
        op = (s.get("args") or {}).get("op")
        if op is None:
            continue
        groups.setdefault((s.get("pid"), op), []).append(s)
    out = []
    for (pid, op), members in groups.items():
        t0 = min(s["ts"] for s in members)
        t1 = max(s["ts"] + s["dur"] for s in members)
        out.append({"name": "commit_op", "ph": "X", "ts": t0,
                    "dur": t1 - t0, "pid": pid, "args": {"op": op},
                    "_members": members})
    return out


# --------------------------------------------------- causal assembly
# Per-REQUEST attribution.  The stage quantiles above answer
# "which stage is slow"; assemble_traces answers "what happened to this
# request": group spans by propagated trace_id, correct per-pid clock
# skew from matched bus send/recv pairs, build the span tree, attach
# the batching fan-in via span links, and emit a per-request critical
# path (network vs quorum wait vs commit vs device dispatch).

_ROOT_PARENT = "0" * 16


def estimate_clock_offsets(doc: dict) -> dict:
    """Per-pid clock offsets (microseconds, relative to the lowest
    measured pid) estimated from matched bus_send/bus_recv span pairs:
    both ends of one frame tag the same `csum`, so for each directed
    pid pair the minimum observed (recv_start - send_end) is
    min_delay + offset; with both directions measured the symmetric
    NTP-style estimate cancels the delay, with one direction the
    min-delay term is assumed zero (biased by the true one-way minimum,
    but bounded by it).  Subtract offsets[pid] from that pid's ts to
    correct."""
    sends: dict = {}
    recvs: dict = {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        csum = args.get("csum")
        if csum is None:
            continue
        if e.get("name") == "bus_send":
            sends.setdefault(csum, []).append(e)
        elif e.get("name") == "bus_recv":
            recvs.setdefault(csum, []).append(e)
    mins: dict = {}  # (src_pid, dst_pid) -> min one-way delta (us)
    for csum, rs in recvs.items():
        for r in rs:
            for s in sends.get(csum, ()):
                if s.get("pid") == r.get("pid"):
                    continue
                d = r["ts"] - (s["ts"] + s.get("dur", 0.0))
                k = (s.get("pid"), r.get("pid"))
                if k not in mins or d < mins[k]:
                    mins[k] = d
    pids = sorted({p for k in mins for p in k})
    if not pids:
        return {}
    offsets = {pids[0]: 0.0}
    frontier = [pids[0]]
    while frontier:
        a = frontier.pop()
        for b in pids:
            if b in offsets:
                continue
            d_ab = mins.get((a, b))
            d_ba = mins.get((b, a))
            if d_ab is None and d_ba is None:
                continue
            if d_ab is not None and d_ba is not None:
                rel = (d_ab - d_ba) / 2.0
            elif d_ab is not None:
                rel = d_ab
            else:
                rel = -d_ba
            offsets[b] = offsets[a] + rel
            frontier.append(b)
    return offsets


def causal_edges(trace: dict) -> list:
    """(parent_span, child_span) pairs of one assembled trace — the
    edges the skew-correction acceptance check walks."""
    by_id = {s["args"]["span_id"]: s for s in trace["spans"]}
    out = []
    for s in trace["spans"]:
        parent = by_id.get(s["args"].get("parent_id"))
        if parent is not None and parent is not s:
            out.append((parent, s))
    return out


def _request_critical_path(spans: list, linked: list) -> dict:
    """One request's wall-time attribution: where its latency actually
    went.  Stage sums come from the trace's own spans plus the window
    spans linked to it across the batching boundary; everything the
    stages do not claim (wire time both ways, queueing between stages,
    the reply delivery) is `network_other_us`."""
    roots = [s for s in spans
             if s["args"].get("parent_id") == _ROOT_PARENT]
    if roots:
        total = sum(s.get("dur", 0.0) for s in roots)
    else:
        t0 = min(s["ts"] for s in spans)
        t1 = max(s["ts"] + s.get("dur", 0.0) for s in spans)
        total = t1 - t0
    def _sum(names, pool):
        return sum(s.get("dur", 0.0) for s in pool
                   if s.get("name") in names)
    quorum = _sum({"commit_quorum"}, spans)
    commit = _sum({"commit_prefetch", "commit_execute", "commit_compact",
                   "journal_write"}, spans)
    dispatch = (_sum({"serving_dispatch", "window_commit",
                      "serving_recovery_replay"}, spans)
                + _sum({"serving_dispatch", "window_commit",
                        "serving_recovery_replay"}, linked))
    stages = {
        "quorum_wait_us": round(quorum, 3),
        "commit_us": round(commit, 3),
        "device_dispatch_us": round(dispatch, 3),
        "network_other_us": round(
            max(0.0, total - quorum - commit - dispatch), 3),
    }
    return {
        "total_us": round(total, 3),
        "stages": stages,
        "owner": max(stages, key=stages.get) if total else None,
    }


def assemble_traces(doc: dict, head_rate: float = 1.0, seed: int = 0,
                    skew_correct: bool = True) -> dict:
    """Group a (merged) trace document's causal spans by trace_id and
    build one span tree per request.

    Returns {"traces": [...], "clock_offsets_us": {...}, summary
    counts}.  Each trace carries its spans (ts skew-corrected), root,
    orphan spans (parent_id points nowhere — MUST be empty on a healthy
    run), the window spans linked to it across the batching boundary,
    the keep decision (deterministic head sample by trace_id hash, OR
    tail retention via the tracers' kept_traces metadata), and its
    per-request critical path."""
    from .context import head_sampled  # local: avoid import cycles

    offsets = estimate_clock_offsets(doc) if skew_correct else {}
    kept = dict((doc.get("metadata") or {}).get("kept_traces") or {})
    by_trace: dict = {}
    links_to: dict = {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        tid = args.get("trace_id")
        lnks = args.get("links")
        if tid is None and not lnks:
            continue
        s = dict(e)
        off = offsets.get(e.get("pid"))
        if off:
            s["ts"] = round(s["ts"] - off, 3)
        if tid is not None:
            by_trace.setdefault(tid, []).append(s)
        for lt in lnks or ():
            if lt != tid:
                links_to.setdefault(lt, []).append(s)
    traces = []
    for tid, spans in sorted(by_trace.items()):
        spans.sort(key=lambda s: s["ts"])
        ids = {s["args"]["span_id"] for s in spans}
        roots = [s for s in spans
                 if s["args"].get("parent_id") == _ROOT_PARENT]
        orphans = [s for s in spans
                   if s["args"].get("parent_id") != _ROOT_PARENT
                   and s["args"].get("parent_id") not in ids]
        linked = sorted(links_to.get(tid, []), key=lambda s: s["ts"])
        reason = kept.get(tid)
        head = head_sampled(int(tid, 16), head_rate, seed)
        traces.append({
            "trace_id": tid,
            "spans": spans,
            "root": roots[0] if len(roots) == 1 else None,
            "roots": len(roots),
            "orphan_spans": orphans,
            "linked_spans": linked,
            "complete": len(roots) == 1 and not orphans,
            "kept": head or reason is not None,
            "keep_reason": ("tail:" + reason if reason is not None
                            else ("head" if head else None)),
            "critical_path": _request_critical_path(spans, linked),
        })
    return {
        "traces": traces,
        "clock_offsets_us": {str(k): round(v, 3)
                             for k, v in offsets.items()},
        "total": len(traces),
        "complete": sum(t["complete"] for t in traces),
        "kept_total": sum(t["kept"] for t in traces),
        "orphan_spans": sum(len(t["orphan_spans"]) for t in traces),
    }


def merge_trace_files(paths: list, out_path: Optional[str] = None) -> dict:
    """Load per-replica trace files and merge; optionally write the
    merged document (the operator-facing `one Perfetto load` artifact)."""
    docs = []
    for p in paths:
        with open(p) as f:
            docs.append(json.load(f))
    merged = merge_traces(docs)
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged
