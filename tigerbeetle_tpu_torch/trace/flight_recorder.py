"""Flight recorder: a bounded ring of per-window telemetry for post-mortem.

The device telemetry plane (parallel/partitioned.py TEL_LAYOUT) answers
"what is the fused route doing NOW"; the flight recorder answers "what
was it doing WHEN it died". Each replica keeps the last-N per-window
records — route decision, decoded telemetry summary, epoch digest when
one was verified — and dumps them as a JSON artifact the moment the
serving path quarantines, recovers, or exhausts its retries (the
PartitionedRouter dumps on shard-loss quarantine and resync, the
ServingSupervisor on every recovery cause). Vortex runs harvest the
same artifacts from their replica scratch dirs.

Cross-process merge is LOSSLESS: beside the raw records the recorder
accumulates log2 histograms (trace/histogram.py — its merge
property) of the device distributions, so `merge_flight_records` over
N replicas' dumps adds bucket counts exactly; quantiles over the merged
document equal quantiles over the union of samples within the
histogram's ~1% relative error.

Artifact naming: FLIGHT_<pid>_<reason>_<seq>.json under the recorder's
`dump_dir` (default: <tempdir>/tb_tpu_flight). The directory is an
argument, never read from the environment.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Optional

from .event import Event
from .histogram import Histogram

# The distributions the recorder accumulates losslessly beside the raw
# ring: fed from each record's telemetry summary when present.
_HIST_KEYS = ("fix_rounds", "exchange_occupancy_pct")


def _flight_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "tb_tpu_flight")


class FlightRecorder:
    """Bounded host-side ring of per-window records + dump-on-fault.

    `record()` is cheap (a deque append + optional histogram feeds) and
    runs once per committed window — always-on production posture, the
    Dapper lesson. `dump(reason)` freezes the ring into a JSON artifact
    and counts the `flight_recorder_dump` catalog event; the artifact
    path is returned and kept in `last_dump_path`."""

    def __init__(self, capacity: int = 64, pid: int = 0, tracer=None,
                 dump_dir: Optional[str] = None):
        assert capacity > 0
        self.capacity = capacity
        self.pid = pid
        self.tracer = tracer
        self.dump_dir = dump_dir
        self.seq = 0          # windows recorded, ever
        self.dumps = 0
        self.last_dump_path: Optional[str] = None
        self._ring: collections.deque = collections.deque(
            maxlen=capacity)
        self._hists = {k: Histogram() for k in _HIST_KEYS}

    # ------------------------------------------------------------ recording

    def record(self, *, window: int, route: str, telemetry=None,
               epoch_digest=None, **detail) -> None:
        """Append one per-window record. `telemetry` is the decoded
        summary dict (see PartitionedRouter._absorb_telemetry); its
        `fix_rounds` / `exchange_occupancy_pct` sample lists also feed
        the recorder's mergeable histograms."""
        rec = {"seq": self.seq, "window": int(window),
               "route": str(route)}
        if telemetry is not None:
            rec["telemetry"] = telemetry
            for key in _HIST_KEYS:
                for v in telemetry.get(key) or ():
                    self._hists[key].record(float(v))
        if epoch_digest is not None:
            rec["epoch_digest"] = str(epoch_digest)
        if detail:
            rec["detail"] = detail
        self._ring.append(rec)
        self.seq += 1

    @property
    def records(self) -> list:
        return list(self._ring)

    # --------------------------------------------------------------- dumping

    def to_dict(self) -> dict:
        return {
            "pid": self.pid,
            "capacity": self.capacity,
            "windows_recorded": self.seq,
            "records": self.records,
            "histograms": {k: h.to_dict()
                           for k, h in self._hists.items() if h.count},
        }

    def dump(self, reason: str, path: Optional[str] = None) -> str:
        """Freeze the ring into FLIGHT_<pid>_<reason>_<seq>.json (or
        `path`) and count flight_recorder_dump tagged with the reason.
        Never raises on I/O: a post-mortem artifact must not turn a
        recovery into a crash — failures land in the returned path
        being '' with the counter still emitted."""
        doc = dict(self.to_dict(), reason=str(reason))
        if path is None:
            d = self.dump_dir or _flight_dir()
            try:
                os.makedirs(d, exist_ok=True)
            except OSError:
                d = tempfile.gettempdir()
            path = os.path.join(
                d, f"FLIGHT_{self.pid}_{reason}_{self.seq:06d}.json")
        try:
            with open(path, "w") as f:
                json.dump(doc, f)
        except OSError:
            path = ""
        self.dumps += 1
        self.last_dump_path = path or None
        if self.tracer is not None:
            self.tracer.count(Event.flight_recorder_dump,
                              reason=str(reason))
        return path


def merge_flight_records(docs: list) -> dict:
    """Merge N replicas' dump documents (as dicts or file paths) into
    one post-mortem view: records concatenate ordered by (pid, seq),
    histograms ADD losslessly per key (integer bucket counts — the
    histogram merge property, so cluster-wide quantiles are exact within
    the histogram error bound)."""
    loaded = []
    for d in docs:
        if isinstance(d, str):
            with open(d) as f:
                d = json.load(f)
        loaded.append(d)
    records = []
    hists: dict = {}
    pids = []
    reasons = []
    for d in loaded:
        pid = d.get("pid", 0)
        pids.append(pid)
        if d.get("reason"):
            reasons.append(d["reason"])
        for r in d.get("records", []):
            records.append(dict(r, pid=pid))
        for k, hd in (d.get("histograms") or {}).items():
            h = Histogram.from_dict(hd)
            if k in hists:
                hists[k].merge(h)
            else:
                hists[k] = h
    records.sort(key=lambda r: (r.get("pid", 0), r.get("seq", 0)))
    return {
        "replicas": sorted(set(pids)),
        "reasons": sorted(set(reasons)),
        "records": records,
        "histograms": {k: h.to_dict() for k, h in hists.items()},
    }
