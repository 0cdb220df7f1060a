"""devhub: benchmark history + regression detection + dashboard.

reference: src/devhub/ + src/scripts/devhub.zig — nightly metrics
(benchmark tx/s, latency, sizes) recorded to a database and rendered on
a dashboard; the CFO fleet pushes failing fuzz seeds to the same place
(src/scripts/cfo.zig:1-41). Here: bench JSON lines append to a JSONL
history; `regressions` flags metrics that dropped against their
trailing median (the reference's nightly-regression purpose); `render`
emits a self-contained HTML dashboard — metric sparklines, regression
badges, parity series, and the latest CFO sweep's failing seeds with
their reproduction commands (no external assets, mirroring the
reference's static devhub page).

A copy of the JAX package's `devhub.py`. Its committed-file panels show
the port's own records, in `static_dir` (default: the port's trace/):
the op-budget panel the newest `opbudget_r*.json` (written by
`torchhound/opbudget.py`), the memory panel `membudget.json`, the
static-analysis panel `static_status.json` and the newest
`tracebudget_r*.json` (written by `testing/static_smoke.py` and
torchhound). Rounds are found by `budget_trail.py` (the JAX package's
`jaxhound/core.py` helper).
"""

from __future__ import annotations

import glob
import html
import json
import os
import time
from typing import Optional

from .budget_trail import newest_round_path

# The port's committed records: its trace/ directory.
_DEFAULT_STATIC_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "trace")


def newest_budget_path(budget_dir: Optional[str] = None) -> str:
    """The newest committed opbudget_r*.json in budget_dir (default: the
    port's trace/)."""
    return newest_round_path(budget_dir or _DEFAULT_STATIC_DIR, "opbudget")


def newest_tracebudget_path(budget_dir: Optional[str] = None) -> str:
    """The newest committed tracebudget_r*.json in budget_dir."""
    return newest_round_path(budget_dir or _DEFAULT_STATIC_DIR,
                             "tracebudget")


def membudget_path(budget_dir: Optional[str] = None) -> str:
    """The memory budget in budget_dir: the port pins one
    `membudget.json`; a directory of rounds is read at its newest
    `membudget_r*.json`."""
    budget_dir = budget_dir or _DEFAULT_STATIC_DIR
    path = os.path.join(budget_dir, "membudget.json")
    if os.path.exists(path):
        return path
    return newest_round_path(budget_dir, "membudget")


NUMERIC_KEYS = (
    "value", "config1_2hot_tps", "config2_10k_tps", "config3_chains_tps",
    "config4_twophase_limits_tps", "config6_serving_tps",
)

# Nested metrics: (display key, path into the record).
NESTED_KEYS = (
    ("serving_sustained_tps", ("serving_batch_latency", "sustained_tps")),
    ("serving_p99_ms", ("serving_batch_latency", "p99_ms")),
    ("serving_p999_ms", ("serving_batch_latency", "p999_ms")),
    # Tracing-cost guard (bench ##trace): recording-vs-NullTracer wall
    # clock on the same commit loop; a creeping ratio is a tracing
    # regression like any other.
    ("trace_overhead_ratio", ("trace", "overhead_ratio")),
    # Causal-propagation cost guard: the same loop with
    # trace-context stamping at sampling 1.0 vs NullTracer; the
    # acceptance ceiling is 1.15x.
    ("trace_ctx_overhead_ratio", ("trace", "ctx_overhead_ratio")),
)

REGRESSION_WINDOW = 8  # trailing runs forming the baseline median
REGRESSION_TOLERANCE = 0.10  # flag drops beyond 10% of the median


def record(history_path: str, bench_json: dict,
           timestamp: Optional[int] = None) -> None:
    entry = dict(bench_json)
    entry["recorded_at"] = timestamp if timestamp is not None else int(time.time())
    with open(history_path, "a") as f:
        f.write(json.dumps(entry) + "\n")


def load(history_path: str) -> list[dict]:
    out = []
    try:
        with open(history_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue  # torn write: skip
    except FileNotFoundError:
        pass
    return out


def _series(entries: list[dict], key: str) -> list:
    for display, path in NESTED_KEYS:
        if key == display:
            out = []
            for e in entries:
                v = e
                for part in path:
                    v = v.get(part) if isinstance(v, dict) else None
                out.append(v)
            return out
    return [e.get(key) for e in entries]


def _median(values: list[float]) -> Optional[float]:
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return None
    mid = len(vals) // 2
    if len(vals) % 2:
        return vals[mid]
    return (vals[mid - 1] + vals[mid]) / 2


# Metrics where a regression is an INCREASE (latency); everything else
# regresses by dropping (throughput).
_HIGHER_IS_WORSE = frozenset({"serving_p99_ms", "serving_p999_ms",
                              "trace_overhead_ratio",
                              "trace_ctx_overhead_ratio"})


def regressions(entries: list[dict]) -> dict:
    """metric -> {latest, baseline, ratio} for metrics whose newest
    value moved more than REGRESSION_TOLERANCE past the median of the
    preceding REGRESSION_WINDOW runs, in that metric's bad direction
    (reference: the devhub dashboard exists to catch exactly these
    overnight)."""
    out = {}
    keys = NUMERIC_KEYS + tuple(d for d, _ in NESTED_KEYS)
    for key in keys:
        series = [v for v in _series(entries, key) if v is not None]
        if len(series) < 2:
            continue
        latest = series[-1]
        baseline = _median(series[-1 - REGRESSION_WINDOW:-1])
        if not baseline:
            continue
        if key in _HIGHER_IS_WORSE:
            bad = latest > baseline * (1 + REGRESSION_TOLERANCE)
        else:
            bad = latest < baseline * (1 - REGRESSION_TOLERANCE)
        if bad:
            out[key] = {"latest": latest, "baseline": baseline,
                        "ratio": round(latest / baseline, 3)}
    return out


def load_cfo(cfo_dir: str) -> Optional[dict]:
    """Newest CFO sweep artifact (cfo/CFO_*.json), or None."""
    paths = sorted(glob.glob(os.path.join(cfo_dir, "CFO_*.json")))
    if not paths:
        return None
    try:
        with open(paths[-1]) as f:
            d = json.load(f)
        d["_path"] = paths[-1]
        return d
    except (OSError, ValueError):
        return None


def _sparkline(values: list[float], width: int = 320, height: int = 48) -> str:
    values = [v for v in values if v is not None]
    if not values:
        return "<svg/>"
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    step = width / max(1, len(values) - 1) if len(values) > 1 else width
    points = " ".join(
        f"{round(i * step, 1)},{round(height - 4 - (v - lo) / span * (height - 8), 1)}"
        for i, v in enumerate(values))
    return (f'<svg width="{width}" height="{height}">'
            f'<polyline fill="none" stroke="#2a6" stroke-width="2" '
            f'points="{points}"/></svg>')


def render(history_path: str, out_path: str,
           cfo_dir: Optional[str] = None,
           entries: Optional[list] = None,
           regress: Optional[dict] = None,
           static_dir: Optional[str] = None) -> int:
    """Render the dashboard; returns the number of history entries.
    `entries`/`regress` let a caller that already loaded the history
    (cmd_devhub's gate) avoid parsing and scanning it twice. The
    static, op-budget and memory panels read their committed files in
    `static_dir` (default: the port's trace/)."""
    if static_dir is None:
        static_dir = _DEFAULT_STATIC_DIR
    if entries is None:
        entries = load(history_path)
    if regress is None:
        regress = regressions(entries)
    rows = []
    for key in NUMERIC_KEYS + tuple(d for d, _ in NESTED_KEYS):
        series = _series(entries, key)
        latest = next((v for v in reversed(series) if v is not None), None)
        flag = ""
        if key in regress:
            r = regress[key]
            flag = (f'<span style="color:#c22;font-weight:600">'
                    f'REGRESSED {r["ratio"]:.2f}x of median '
                    f'{r["baseline"]:,.0f}</span>')
        rows.append(
            "<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td></tr>".format(
                html.escape(key),
                "-" if latest is None else f"{latest:,.0f}",
                _sparkline(series), flag))
    # Oracle-parity series: every recorded run must say True.
    parity = [e.get("config5_oracle_parity") for e in entries
              if e.get("config5_oracle_parity") is not None]
    parity_html = (
        f"<p>oracle parity: {sum(1 for p in parity if p)}/{len(parity)} "
        f"runs clean"
        + ("" if all(parity) else
           ' — <b style="color:#c22">PARITY FAILURE RECORDED</b>')
        + "</p>") if parity else ""
    # Fallback observability: the newest run's per-config per-cause
    # host-fallback counters (bench fallback_diagnostics). "Zero host
    # fallbacks" is a measured invariant — a nonzero count is rendered
    # as loudly as a throughput regression.
    fb_html = ""
    fb = next((e.get("fallback_diagnostics") for e in reversed(entries)
               if isinstance(e.get("fallback_diagnostics"), dict)), None)
    if fb:
        rows_fb = []
        any_host_fb = False
        for cfg in sorted(fb):
            d = fb[cfg] or {}
            host = (d.get("host_fallbacks", 0) or 0) + \
                (d.get("window_fallbacks", 0) or 0)
            any_host_fb = any_host_fb or host > 0
            causes = d.get("causes") or {}
            cause_txt = ", ".join(
                f"{k}={v}" for k, v in sorted(causes.items())) or "-"
            rows_fb.append(
                "<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td>"
                "</tr>".format(
                    html.escape(cfg), host,
                    d.get("escalations", 0) or 0, html.escape(cause_txt)))
        badge_fb = ("" if not any_host_fb else
                    '<p style="color:#c22;font-weight:700">HOST FALLBACKS '
                    'RECORDED — the fast path left the device</p>')
        fb_html = (
            "<h2>fallback diagnostics (latest run)</h2>" + badge_fb
            + "<table><tr><th>config</th><th>host fallbacks</th>"
              "<th>escalations</th><th>causes</th></tr>"
            + "".join(rows_fb) + "</table>")
    # Recovery panel (next to the fallback diagnostics): the newest
    # run's chaos/recovery counters — retries, backoff, replayed
    # windows, verified checksum epochs, recoveries by cause. A nonzero
    # recovery or checksum mismatch in a bench run means the serving
    # pipeline quarantined device state mid-run: rendered as loudly as
    # a host fallback.
    rec_html = ""
    rec = next((e.get("recovery_diagnostics")
                for e in reversed(entries)
                if isinstance(e.get("recovery_diagnostics"), dict)
                and e.get("recovery_diagnostics")), None)
    if rec is None:
        fbd = next((e.get("fallback_diagnostics")
                    for e in reversed(entries)
                    if isinstance(e.get("fallback_diagnostics"), dict)),
                   None) or {}
        rec = {cfg: d.get("recovery") for cfg, d in fbd.items()
               if isinstance(d, dict)
               and isinstance(d.get("recovery"), dict)}
    if rec:
        rows_rec = []
        any_rec = False
        for cfg in sorted(rec):
            d = rec[cfg] or {}
            causes = d.get("recoveries") or {}
            n_rec = sum(causes.values()) if causes else 0
            mism = d.get("checksum_mismatches", 0) or 0
            any_rec = any_rec or n_rec > 0 or mism > 0
            cause_txt = ", ".join(
                f"{k}={v}" for k, v in sorted(causes.items())) or "-"
            rows_rec.append(
                "<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td>"
                "<td>{}</td><td>{}</td><td>{}</td></tr>".format(
                    html.escape(cfg), d.get("retries", 0) or 0,
                    d.get("backoff_s", 0) or 0,
                    d.get("replayed_windows", 0) or 0,
                    d.get("epochs_verified", 0) or 0, mism,
                    html.escape(cause_txt)))
        badge_rec = ("" if not any_rec else
                     '<p style="color:#c22;font-weight:700">RECOVERIES '
                     'RECORDED — device state was quarantined and '
                     'replayed</p>')
        rec_html = (
            "<h2>recovery / verified epochs (latest run)</h2>" + badge_rec
            + "<table><tr><th>config</th><th>retries</th>"
              "<th>backoff s</th><th>replayed windows</th>"
              "<th>epochs verified</th><th>checksum mismatches</th>"
              "<th>recoveries by cause</th></tr>"
            + "".join(rows_rec) + "</table>")
    # Dispatch-route panel: which kernel route each config's windows
    # took ("chain" = the default scan-form whole-window dispatch;
    # "partitioned_chain" / "partitioned_per_batch" = the sharded-state
    # routes, fused scan vs per-prepare) and the per-cause prepares
    # that fell out of chain windows — a shift away from a chain route
    # on a plain workload is a routing regression, rendered next to
    # the fallback diagnostics it would show up in.
    route_html = ""
    routes = next((e.get("dispatch_routes") for e in reversed(entries)
                   if isinstance(e.get("dispatch_routes"), dict)
                   and e.get("dispatch_routes")), None)
    if routes is None:
        fbd = next((e.get("fallback_diagnostics")
                    for e in reversed(entries)
                    if isinstance(e.get("fallback_diagnostics"), dict)),
                   None) or {}
        routes = {cfg: d.get("routes") for cfg, d in fbd.items()
                  if isinstance(d, dict)
                  and isinstance(d.get("routes"), dict)
                  and (d["routes"].get("windows")
                       or d["routes"].get("chain_batch_fallbacks"))}
    if routes:
        rows_rt = []
        for cfg in sorted(routes):
            d = routes[cfg] or {}
            wins = d.get("windows") or {}
            if not wins and d.get("route"):
                depths = ",".join(str(x) for x in
                                  d.get("window_depths") or []) or "-"
                wins_txt = f"{d['route']} (depths {depths})"
            else:
                wins_txt = ", ".join(
                    f"{k}={v}" for k, v in sorted(wins.items())) or "-"
            cbf = d.get("chain_batch_fallbacks") or {}
            cbf_txt = ", ".join(
                f"{k}={v}" for k, v in sorted(cbf.items())) or "-"
            rows_rt.append(
                "<tr><td>{}</td><td>{}</td><td>{}</td></tr>".format(
                    html.escape(cfg), html.escape(wins_txt),
                    html.escape(cbf_txt)))
        route_html = (
            "<h2>dispatch routes (latest run)</h2>"
            "<table><tr><th>config</th><th>windows by route</th>"
            "<th>chain per-prepare fallbacks</th></tr>"
            + "".join(rows_rt) + "</table>")
    # Host-staging panel, next to the dispatch-routes table:
    # double-buffered window staging per config — how much host pack/
    # transfer work ran (work_ms), how much of it the dispatch path
    # actually waited on (stall_ms), windows staged ahead vs packed
    # inline, and the headline host_stall_fraction (1.0 = staging fully
    # synchronous; the overlap gate leg ceilings the same number on a
    # live run). A fraction near 1.0 WITH overlap enabled means the
    # double buffer stopped hiding the pack — a pipelining regression.
    stage_html = ""
    staging = next((e.get("host_staging") for e in reversed(entries)
                    if isinstance(e.get("host_staging"), dict)
                    and e.get("host_staging")), None)
    if staging is None:
        fbd = next((e.get("fallback_diagnostics")
                    for e in reversed(entries)
                    if isinstance(e.get("fallback_diagnostics"), dict)),
                   None) or {}
        staging = {cfg: d.get("staging") for cfg, d in fbd.items()
                   if isinstance(d, dict)
                   and isinstance(d.get("staging"), dict)
                   and d["staging"].get("windows")}
    if staging:
        rows_st = []
        any_sync = False
        for cfg in sorted(staging):
            d = staging[cfg] or {}
            frac = d.get("host_stall_fraction")
            overlap_on = bool(d.get("overlap", True))
            sync_flag = (overlap_on and frac is not None
                         and frac >= 0.9 and d.get("staged"))
            any_sync = any_sync or bool(sync_flag)
            frac_txt = "-" if frac is None else f"{frac:.4f}"
            if sync_flag:
                frac_txt = ('<span style="color:#c22;font-weight:600">'
                            f"{frac:.4f}</span>")
            rows_st.append(
                "<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td>"
                "<td>{}</td><td>{}</td><td>{}</td><td>{}</td></tr>"
                .format(html.escape(cfg),
                        "on" if overlap_on else "off",
                        d.get("windows", 0) or 0,
                        d.get("staged", 0) or 0,
                        d.get("misses", 0) or 0,
                        d.get("work_ms", 0) or 0,
                        d.get("stall_ms", 0) or 0, frac_txt))
        badge_st = ("" if not any_sync else
                    '<p style="color:#c22;font-weight:700">HOST STALL '
                    'NEAR 1.0 WITH OVERLAP ON — window staging is no '
                    'longer hidden behind device execution</p>')
        stage_html = (
            "<h2>host staging / overlap (latest run)</h2>" + badge_st
            + "<table><tr><th>config</th><th>overlap</th>"
              "<th>windows</th><th>staged ahead</th><th>misses</th>"
              "<th>staging work ms</th><th>stall ms</th>"
              "<th>host stall fraction</th></tr>"
            + "".join(rows_st) + "</table>")
    # Admission panel: the latest run's ##admission record —
    # per-class admitted vs shed-by-reason under the sessionized
    # Zipfian overload, the shed line reached, queue occupancy, and
    # sustained ADMITTED events/s (the success metric under overload is
    # admitted throughput + per-class admitted p99 while lower classes
    # shed explicitly, not raw tps). RED badge when the top class shed
    # for shed_line/deadline (the priority ladder regressed) or
    # conservation broke (a silent drop — the one thing the plane
    # promises never happens).
    adm_html = ""
    adm = next((e.get("admission") for e in reversed(entries)
                if isinstance(e.get("admission"), dict)
                and e.get("admission")), None)
    if adm and isinstance(adm.get("classes"), dict):
        by_prio = sorted(adm["classes"].items(),
                         key=lambda kv: kv[1].get("priority", 0))
        top_name, top_d = by_prio[0]
        bad_top = sorted(r for r in (top_d.get("shed") or {})
                         if r in ("shed_line", "deadline"))
        cons = adm.get("conservation") or {}
        bad_cons = not cons.get("ok", True)
        rows_ad = []
        for name, d in by_prio:
            shed = d.get("shed") or {}
            shed_txt = ", ".join(f"{k}={v}"
                                 for k, v in sorted(shed.items())) or "-"
            wait = d.get("admit_wait_ms") or {}
            p99, slo = wait.get("p99"), d.get("slo_ms")
            p99_txt = "-" if p99 is None else f"{p99:.1f}"
            if p99 is not None and slo is not None and p99 > slo:
                p99_txt = ('<span style="color:#c22;font-weight:600">'
                           f"{p99:.1f}</span>")
            rows_ad.append(
                "<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td>"
                "<td>{}</td><td>{}</td></tr>".format(
                    html.escape(name), d.get("submitted", 0) or 0,
                    d.get("admitted", 0) or 0, html.escape(shed_txt),
                    p99_txt, "-" if slo is None else slo))
        badge_ad = ""
        if bad_top or bad_cons:
            why = []
            if bad_top:
                why.append(f"top class '{top_name}' shed for {bad_top}")
            if bad_cons:
                why.append("conservation broke (silent drop)")
            badge_ad = ('<p style="color:#c22;font-weight:700">'
                        'ADMISSION RED: '
                        + html.escape("; ".join(why)) + "</p>")
        q = adm.get("queue") or {}
        adm_html = (
            "<h2>admission plane (latest run)</h2>" + badge_ad
            + "<p>shed level {} &middot; queue occupancy {} &middot; "
              "sustained {} admitted events/s virtual ({} wall) &middot; "
              "{} live sessions of a {} population</p>".format(
                  adm.get("shed_level", "-"), q.get("occupancy", "-"),
                  adm.get("sustained_admitted_eps_virtual", "-"),
                  adm.get("admitted_eps_wall", "-"),
                  adm.get("sessions", "-"),
                  adm.get("session_population", "-"))
            + "<table><tr><th>class</th><th>submitted</th>"
              "<th>admitted</th><th>shed by reason</th>"
              "<th>admitted p99 ms</th><th>slo ms</th></tr>"
            + "".join(rows_ad) + "</table>")
    # Op-budget table (next to the fallback diagnostics): the newest
    # run's heavy-op census per kernel tier vs the committed gate
    # ceilings (the NEWEST opbudget_r*.json — resolved, not
    # hardcoded, so a new budget round shows up without a devhub edit)
    # — compile-footprint regressions are rendered as loudly as
    # throughput ones.
    ob_html = ""
    ob = next((e.get("opbudget") for e in reversed(entries)
               if isinstance(e.get("opbudget"), dict)
               and "error" not in e.get("opbudget", {})), None)
    if ob:
        budgets = {}
        try:
            with open(newest_budget_path(static_dir)) as f:
                budgets = json.load(f).get("budget", {})
        except (OSError, ValueError):
            pass
        rows_ob = []
        any_over = False
        for tier in sorted(ob):
            d = ob[tier] or {}
            total = d.get("heavy_total")
            limit = (budgets.get(tier) or {}).get("heavy_total")
            over = (total is not None and limit is not None
                    and total > limit)
            any_over = any_over or over
            classes = d.get("heavy") or {}
            cls_txt = " ".join(f"{k}={v}" for k, v in classes.items()
                               if v) or "-"
            flag = ('<span style="color:#c22;font-weight:600">OVER '
                    'BUDGET</span>' if over else "")
            rows_ob.append(
                "<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td>"
                "<td>{}</td><td>{}</td></tr>".format(
                    html.escape(tier),
                    "-" if total is None else total,
                    "-" if limit is None else limit,
                    html.escape(cls_txt),
                    d.get("operand_mb", "-"), flag))
        badge_ob = ("" if not any_over else
                    '<p style="color:#c22;font-weight:700">OP BUDGET '
                    'EXCEEDED — scripts/gate.py would be RED</p>')
        ob_html = (
            "<h2>op budget (latest run vs committed ceilings)</h2>"
            + badge_ob
            + "<table><tr><th>kernel tier</th><th>heavy ops</th>"
              "<th>budget</th><th>by class</th><th>operand MB</th>"
              "<th></th></tr>"
            + "".join(rows_ob) + "</table>")
    # Static-analysis panel: the gate `static` leg's last verdict
    # (static_status.json in static_dir, written by
    # testing/static_smoke.py) — per-pass ok flags with finding samples
    # and the negative-proof verdicts — next to the committed
    # capture-budget head (the NEWEST tracebudget_r*.json there, resolved
    # newest_budget_path-style so a new pinned round shows up without a
    # devhub edit).
    st_html = ""
    st = None
    try:
        with open(os.path.join(static_dir, "static_status.json")) as f:
            st = json.load(f)
    except (OSError, ValueError, ImportError):
        pass
    if isinstance(st, dict):
        rows_st = []
        any_red = False
        for name in sorted(st.get("passes") or {}):
            d = st["passes"][name] or {}
            ok = bool(d.get("ok"))
            any_red = any_red or not ok
            sample = "; ".join(d.get("findings") or [])[:200] or "-"
            flag = ("clean" if ok else
                    '<span style="color:#c22;font-weight:600">RED</span>')
            rows_st.append(
                "<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td>"
                "</tr>".format(
                    html.escape(name), flag, d.get("n_findings", 0),
                    html.escape(sample)))
        negs = st.get("negatives") or {}
        n_ok = sum(1 for v in negs.values() if v)
        neg_red = n_ok < len(negs)
        any_red = any_red or neg_red
        neg_txt = (
            f"{n_ok}/{len(negs)} injected violations red as required"
            if negs else "-")
        if neg_red:
            neg_txt = ('<span style="color:#c22;font-weight:600">'
                       + html.escape(neg_txt) + "</span>")
        else:
            neg_txt = html.escape(neg_txt)
        tb_txt = "-"
        try:
            with open(newest_tracebudget_path(static_dir)) as f:
                tb = json.load(f)
            tb_txt = "{}: {} entries pinned, depth matrix {}".format(
                html.escape(str(st.get("tracebudget") or "")),
                len(tb.get("entries") or {}),
                html.escape(str((tb.get("matrix") or {}).get(
                    "depths", "-"))))
        except (OSError, ValueError, ImportError):
            pass
        badge_st = ("" if not any_red else
                    '<p style="color:#c22;font-weight:700">STATIC '
                    'ANALYSIS RED — scripts/gate.py static leg would '
                    'fail</p>')
        st_html = (
            "<h2>static analysis (torchhound passes, last gate leg)</h2>"
            + badge_st
            + "<p>{} registry entries; retrace budget {}; negative "
              "proofs: {}</p>".format(
                  st.get("n_entries", "-"), tb_txt, neg_txt)
            + "<table><tr><th>pass</th><th></th><th>findings</th>"
              "<th>sample</th></tr>"
            + "".join(rows_st) + "</table>")
    # Shard-balance panel (bench ##shard): the partitioned route's
    # events-per-shard spread, cross-shard fraction, and exchange
    # overflow count — a skewed ownership hash or an overflow-prone
    # exchange capacity shows up here before it shows up as fallbacks.
    sh_html = ""
    sh = next((e.get("shard_balance") for e in reversed(entries)
               if isinstance(e.get("shard_balance"), dict)
               and "error" not in e.get("shard_balance", {})), None)
    if sh:
        owned = [int(x) for x in (sh.get("events_per_shard") or [])]
        peak = max(owned) if owned else 1
        rows_sh = []
        for i, n in enumerate(owned):
            bar = '<div style="background:#62a;height:10px;width:{}px">' \
                  '</div>'.format(max(1, round(n / (peak or 1) * 240)))
            rows_sh.append(
                "<tr><td>shard {}</td><td>{}</td><td>{}</td></tr>".format(
                    i, n, bar))
        over = int(sh.get("exchange_overflows") or 0)
        warn = ("" if not over else
                '<p style="color:#c22;font-weight:700">EXCHANGE '
                'OVERFLOWS — per-shard capacity too small for this '
                'workload</p>')
        bytes_dev = sh.get("state_bytes_per_device")
        bytes_rep = sh.get("state_bytes_replicated_equiv")
        ratio = (f" ({bytes_dev / bytes_rep:.3f}x of replicated)"
                 if bytes_dev and bytes_rep else "")
        # Elastic-shards rows (##shard `migration` / `hot_range`): the
        # probe's live split migration — duration, rows moved, windows
        # served under double-write — and the degenerate-hot-account
        # verdict (unsplittable = the remedy is AT2 lane parallelism
        # within the account's commit lane, not placement).
        mig = sh.get("migration")
        mig_html = ""
        if isinstance(mig, dict):
            mig_html = (
                "<p>live migration: {} {}&rarr;{} — {} rows copied in "
                "{:.3f}s, {} double-write window(s), {} window(s) "
                "committed while in flight</p>".format(
                    mig.get("kind", "-"), mig.get("src", "-"),
                    mig.get("dst", "-"), mig.get("rows_copied", 0),
                    float(mig.get("duration_s") or 0.0),
                    mig.get("double_write_windows", 0),
                    mig.get("windows_live", 0)))
        hr = sh.get("hot_range")
        hr_html = ""
        if isinstance(hr, dict):
            style = (' style="color:#c60;font-weight:700"'
                     if hr.get("verdict") == "unsplittable" else "")
            hr_html = (
                "<p{}>hot-range detector: {} (shard {}, top-account "
                "fraction {:.0%}) — {}</p>".format(
                    style, hr.get("verdict", "-"), hr.get("shard", "-"),
                    float(hr.get("fraction") or 0.0),
                    hr.get("note", "")))
        sh_html = (
            "<h2>shard balance (partitioned route, latest run)</h2>"
            + warn
            + "<p>{} shards, cross-shard fraction {:.1%} "
              "({} transfers), {} exchange overflows, "
              "{} state bytes/device{}</p>".format(
                  sh.get("n_shards", "-"),
                  float(sh.get("cross_shard_fraction") or 0.0),
                  sh.get("cross_shard_transfers", 0), over,
                  "-" if bytes_dev is None else bytes_dev,
                  ratio)
            + mig_html + hr_html
            + "<table><tr><th>shard</th><th>events owned</th><th></th>"
              "</tr>" + "".join(rows_sh) + "</table>")
    # Device-telemetry panel: the fused route's on-device measurements
    # (bench ##shard record's `telemetry` sub-dict, decoded from the
    # harvested TEL_LAYOUT block) — exchange-headroom burn first (the
    # early warning BEFORE overflows become host fallbacks), then the
    # fixpoint-round distribution, decoded poison causes, and the
    # flight-recorder activity counters.
    dt_html = ""
    dt = (sh or {}).get("telemetry") if isinstance(sh, dict) else None
    if isinstance(dt, dict):
        occ_txt = "-"
        occ_warn = ""
        try:
            from .trace import Histogram
            oh = Histogram.from_dict(dt.get("exchange_occupancy") or {})
            if oh.count:
                p99 = oh.quantile(0.99)
                occ_txt = ("p50 {:.1f}% / p99 {:.1f}% of lane capacity "
                           "({} samples)").format(
                               oh.quantile(0.50), p99, oh.count)
                if p99 is not None and p99 > 85.0:
                    occ_warn = (
                        '<p style="color:#c22;font-weight:700">'
                        'EXCHANGE HEADROOM BURNING — p99 occupancy '
                        'past the 85% SLO threshold</p>')
        except (AssertionError, ValueError, TypeError):
            pass
        fr = dt.get("fixpoint_rounds") or {}
        fr_txt = ("-" if not fr.get("count") else
                  "p50 {} / p99 {} / max {} over {} prepares".format(
                      fr.get("p50", "-"), fr.get("p99", "-"),
                      fr.get("max", "-"), fr.get("count", 0)))
        causes = dt.get("device_poison_causes") or {}
        cause_txt = ", ".join(f"{k}={v}"
                              for k, v in sorted(causes.items())) or "none"
        dt_html = (
            "<h2>device telemetry (fused partitioned route, latest "
            "run)</h2>" + occ_warn
            + "<table>"
              "<tr><td>exchange occupancy</td><td>{}</td></tr>"
              "<tr><td>fixpoint rounds</td><td>{}</td></tr>"
              "<tr><td>poison causes (decoded)</td><td>{}</td></tr>"
              "<tr><td>write-back rows</td><td>{}</td></tr>"
              "<tr><td>shard capacity hits</td><td>{}</td></tr>"
              "<tr><td>flight recorder</td>"
              "<td>{} windows ringed, {} dumps</td></tr>"
              "</table>".format(
                  html.escape(occ_txt), html.escape(fr_txt),
                  html.escape(cause_txt),
                  dt.get("writeback_rows", 0),
                  dt.get("shard_capacity_hits", 0),
                  dt.get("flight_windows", 0),
                  dt.get("flight_dumps", 0)))
    # Commit-pipeline panel: the newest run's per-stage trace aggregates
    # (bench ##trace, recorded under a recording tracer) as time shares —
    # the operator-facing answer to "where does a commit go", next to the
    # tracing-cost guard (NullTracer vs recording wall clock).
    tr_html = ""
    tr = next((e.get("trace") for e in reversed(entries)
               if isinstance(e.get("trace"), dict)
               and isinstance(e.get("trace").get("commit_stages"), dict)),
              None)
    if tr:
        stages = tr["commit_stages"]
        total_us = sum(s.get("sum_us", 0) for s in stages.values()) or 1.0
        rows_tr = []
        for stage in ("commit_prefetch", "commit_execute",
                      "commit_compact", "commit_checkpoint"):
            s = stages.get(stage)
            if s is None:
                continue
            share = s.get("sum_us", 0) / total_us
            bar = '<div style="background:#2a6;height:10px;width:{}px">' \
                  '</div>'.format(max(1, round(share * 240)))
            rows_tr.append(
                "<tr><td>{}</td><td>{}</td><td>{:.1f}</td><td>{:.1%}</td>"
                "<td>{}</td></tr>".format(
                    html.escape(stage), s.get("count", 0),
                    s.get("sum_us", 0) / 1000.0, share, bar))
        guard = ""
        if tr.get("overhead_ratio") is not None:
            guard = ("<p>tracing cost guard: NullTracer {}s vs recording "
                     "{}s ({}x) over {} ops</p>").format(
                tr.get("null_s"), tr.get("recording_s"),
                tr.get("overhead_ratio"), tr.get("ops"))
        tr_html = (
            "<h2>commit pipeline (latest traced run)</h2>" + guard
            + "<table><tr><th>stage</th><th>spans</th><th>total ms</th>"
              "<th>share</th><th></th></tr>"
            + "".join(rows_tr) + "</table>")
    # SLO panel: every declared objective (perf/slo.json) evaluated
    # against the recorded runs — latest value vs threshold, burn rate
    # over the trailing burn window, breach badges. Rendered even when
    # all green: an invisible SLO is an unenforced one.
    slo_html = ""
    try:
        from .trace.slo import (burn_rates, evaluate_bench_record,
                                load_objectives)

        slo_cfg = load_objectives()
    except (OSError, ValueError, ImportError):
        slo_cfg = None
    if slo_cfg is not None and entries:
        per_run = [evaluate_bench_record(e, slo_cfg["objectives"])
                   for e in entries]
        burn = burn_rates(per_run, slo_cfg["burn_window_runs"],
                          slo_cfg["burn_budget"])
        rows_slo = []
        any_breach = False
        for o, latest in zip(slo_cfg["objectives"], per_run[-1]):
            b = burn.get(o.name, {})
            badge_cell = ""
            if latest["ok"] is False:
                badge_cell = ('<span style="color:#c22;font-weight:600">'
                              'BREACHED</span>')
            elif b.get("badge"):
                badge_cell = ('<span style="color:#c60;font-weight:600">'
                              'BURNING</span>')
            any_breach = any_breach or bool(badge_cell)
            val = latest["value"]
            rows_slo.append(
                "<tr><td>{}</td><td>p{:g} {} &le; {:g} {}</td>"
                "<td>{}</td><td>{:.0%} of {} runs</td><td>{}</td>"
                "</tr>".format(
                    html.escape(o.name), o.quantile * 100,
                    html.escape(o.event), o.threshold,
                    html.escape(o.unit),
                    "-" if val is None else f"{val:g} {o.unit}",
                    b.get("burn_rate", 0.0), b.get("evaluated", 0),
                    badge_cell))
        badge_slo = ("" if not any_breach else
                     '<p style="color:#c22;font-weight:700">SLO BREACH / '
                     'BURN — an objective is out of budget</p>')
        slo_html = (
            "<h2>SLOs (perf/slo.json vs recorded runs)</h2>" + badge_slo
            + "<table><tr><th>objective</th><th>declared</th>"
              "<th>latest</th><th>burn rate</th><th></th></tr>"
            + "".join(rows_slo) + "</table>")
    # Critical-path panel: stage-share attribution of the slowest-decile
    # windows from the newest traced run (trace/merge.py critical_path
    # over the bench probe's merged cluster trace) — the operator-facing
    # answer to "which stage owns p99".
    cp_html = ""
    cp = next((e.get("trace", {}).get("critical_path")
               for e in reversed(entries)
               if isinstance(e.get("trace"), dict)
               and isinstance(e.get("trace").get("critical_path"), dict)),
              None)
    if cp:
        rows_cp = []
        for stage, share in (cp.get("stage_share") or {}).items():
            bar = '<div style="background:#26c;height:10px;width:{}px">' \
                  '</div>'.format(max(1, round(share * 240)))
            rows_cp.append(
                "<tr><td>{}</td><td>{:.1%}</td><td>{}</td></tr>".format(
                    html.escape(stage), share, bar))
        cp_html = (
            "<h2>p99 critical path (latest traced run)</h2>"
            "<p>slowest {} of {} windows ({} units, threshold "
            "{} ms, p99 {} ms) — p99 owned by <b>{}</b></p>".format(
                cp.get("windows_analyzed", 0), cp.get("windows_total", 0),
                html.escape(str(cp.get("window_event", ""))),
                cp.get("threshold_ms", "-"), cp.get("p99_ms", "-"),
                html.escape(str(cp.get("p99_owner", "-"))))
            + "<table><tr><th>stage</th><th>share of slow-window time"
              "</th><th></th></tr>"
            + "".join(rows_cp) + "</table>")
    # Per-request waterfall panel: the newest traced run's
    # assembled request traces (bench ##trace `request_waterfall`, from
    # trace/merge.py assemble_traces) — one row per kept request, its
    # wall time broken into quorum wait / commit / device dispatch /
    # network+other, stacked as a waterfall bar. The causal-propagation
    # cost guard rides the same record as ctx_overhead_ratio.
    wf_html = ""
    wf = next((e.get("trace", {}).get("request_waterfall")
               for e in reversed(entries)
               if isinstance(e.get("trace"), dict)
               and e.get("trace").get("request_waterfall")),
              None)
    if wf:
        colors = {"quorum_wait_us": "#c62", "commit_us": "#2a6",
                  "device_dispatch_us": "#26c",
                  "network_other_us": "#aaa"}
        peak = max((r.get("total_us") or 1.0) for r in wf) or 1.0
        rows_wf = []
        for r in wf[:12]:
            stages = r.get("stages") or {}
            segs = "".join(
                '<div style="background:{};height:10px;width:{}px;'
                'display:inline-block"></div>'.format(
                    colors.get(k, "#888"),
                    max(0, round((stages.get(k, 0.0) or 0.0)
                                 / peak * 320)))
                for k in colors)
            rows_wf.append(
                "<tr><td><code>{}</code></td><td>{:.2f}</td><td>{}</td>"
                "<td>{}</td><td>{}</td></tr>".format(
                    html.escape(str(r.get("trace_id", ""))[:16]),
                    (r.get("total_us") or 0.0) / 1000.0,
                    html.escape(str(r.get("owner", "-"))),
                    html.escape(str(r.get("keep_reason", "-"))),
                    segs))
        legend = " ".join(
            '<span style="background:{};padding:0 .5em">&nbsp;</span> {}'
            .format(c, html.escape(k.replace("_us", "")))
            for k, c in colors.items())
        guard_ctx = ""
        tr_rec = next((e.get("trace") for e in reversed(entries)
                       if isinstance(e.get("trace"), dict)
                       and e.get("trace").get("ctx_overhead_ratio")
                       is not None), None)
        if tr_rec:
            guard_ctx = ("<p>causal-propagation cost guard: traced "
                         "(sampling 1.0) vs NullTracer {}x "
                         "(ceiling 1.15x)</p>").format(
                             tr_rec.get("ctx_overhead_ratio"))
        wf_html = (
            "<h2>per-request waterfall (latest traced run)</h2>"
            + guard_ctx + f"<p>{legend}</p>"
            + "<table><tr><th>trace id</th><th>total ms</th>"
              "<th>owner</th><th>kept</th><th>waterfall</th></tr>"
            + "".join(rows_wf) + "</table>")
    # Performance-observatory panels (bench ##profile):
    # achieved-vs-roofline fraction per dispatch tier, the sampled
    # dispatch_device_time series, the memory watermark vs the NEWEST
    # committed membudget (resolved, not hardcoded — a new
    # budget round shows up without a devhub edit), and the burn-rate
    # alert engine's rule catalog + firing state.
    obs_html = ""
    pf = next((e.get("profile") for e in reversed(entries)
               if isinstance(e.get("profile"), dict)
               and "error" not in e.get("profile", {})), None)
    if pf:
        # Roofline attribution per tier.
        rows_rf = []
        for tier in sorted(pf.get("roofline") or {}):
            d = pf["roofline"][tier] or {}
            frac = float(d.get("fraction") or 0.0)
            bar = '<div style="background:#a42;height:10px;width:{}px">' \
                  '</div>'.format(max(1, round(min(frac, 1.0) * 240)))
            rows_rf.append(
                "<tr><td>{}</td><td>{:.3f}</td><td>{:.3f}</td>"
                "<td>{:.1%}</td><td>{}</td></tr>".format(
                    html.escape(tier),
                    float(d.get("roofline_seconds") or 0.0) * 1e3,
                    float(d.get("measured_p50_s") or 0.0) * 1e3,
                    frac, bar))
        rows_dd = []
        for key in sorted(pf.get("dispatch_device_time") or {}):
            m = pf["dispatch_device_time"][key] or {}
            p50, p99 = m.get("p50_us"), m.get("p99_us")
            rows_dd.append(
                "<tr><td><code>{}</code></td><td>{}</td><td>{}</td>"
                "<td>{}</td></tr>".format(
                    html.escape(key), m.get("count", 0),
                    "-" if p50 is None else f"{p50 / 1e3:.3f}",
                    "-" if p99 is None else f"{p99 / 1e3:.3f}"))
        sampler = pf.get("sampler") or {}
        plat = (pf.get("cost_model") or {}).get("platform", "-")
        obs_html += (
            "<h2>performance observatory: dispatch roofline "
            "(latest run)</h2>"
            "<p>platform {} &middot; {} dispatches, {} sampled "
            "(1-in-{})</p>".format(
                html.escape(str(plat)), sampler.get("dispatches", "-"),
                sampler.get("samples", "-"),
                sampler.get("sample_every", "-"))
            + "<table><tr><th>tier</th><th>roofline ms</th>"
              "<th>measured p50 ms</th><th>of roofline</th><th></th>"
              "</tr>" + "".join(rows_rf) + "</table>"
            + "<table><tr><th>dispatch series</th><th>samples</th>"
              "<th>p50 ms</th><th>p99 ms</th></tr>"
            + "".join(rows_dd) + "</table>")
        # Memory watermark vs the committed membudget pins.
        mwr = (pf.get("memwatch") or {}).get("last") or {}
        reds = (pf.get("memwatch") or {}).get("reds") or []
        if mwr:
            pins = {}
            try:
                with open(membudget_path(static_dir)) as f:
                    pins = json.load(f).get("components", {})
            except (OSError, ValueError, ImportError):
                pass
            rows_mw = []
            comps = mwr.get("components") or {}
            for name in sorted(set(comps) | set(pins)):
                cur, pin = comps.get(name), pins.get(name)
                over = (cur is not None and pin is not None
                        and cur > pin)
                flag = ('<span style="color:#c22;font-weight:600">OVER '
                        'PIN</span>' if over else "")
                rows_mw.append(
                    "<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td>"
                    "</tr>".format(
                        html.escape(name),
                        "-" if cur is None else cur,
                        "-" if pin is None else pin, flag))
            badge_mw = ""
            if reds:
                badge_mw = ('<p style="color:#c22;font-weight:700">'
                            'MEMORY WATERMARK RED: '
                            + html.escape("; ".join(reds)[:300]) + "</p>")
            head = mwr.get("headroom_bytes")
            obs_html += (
                "<h2>memory watermark (vs committed membudget)</h2>"
                + badge_mw
                + "<p>{} resident bytes &middot; headroom {} &middot; "
                  "{} observation(s)</p>".format(
                      mwr.get("total_bytes", "-"),
                      "-" if head is None else head,
                      (pf.get("memwatch") or {}).get(
                          "observations", "-"))
                + "<table><tr><th>component</th><th>measured</th>"
                  "<th>budget pin</th><th></th></tr>"
                + "".join(rows_mw) + "</table>")
        # Burn-rate alerts: declared rules + the latest run's verdicts.
        al = pf.get("alerts") or {}
        rules_cfg = []
        try:
            from .trace.alerts import load_alert_rules
            rules_cfg = load_alert_rules()["rules"]
        except (OSError, ValueError, ImportError):
            pass
        if rules_cfg or al:
            active = set(al.get("active") or [])
            rows_al = []
            for r in rules_cfg:
                state = ("<span style='color:#c22;font-weight:600'>"
                         "FIRING</span>" if r.name in active else "ok")
                rows_al.append(
                    "<tr><td>{}</td><td>{}</td><td>{}</td>"
                    "<td>{}/{} ticks @ {:g}/{:g}</td>"
                    "<td><a href=\"{}\">runbook</a></td><td>{}</td>"
                    "</tr>".format(
                        html.escape(r.name), html.escape(r.objective),
                        html.escape(r.severity), r.fast_window,
                        r.slow_window, r.fast_burn, r.slow_burn,
                        html.escape(r.runbook), state))
            badge_al = ""
            if active:
                badge_al = ('<p style="color:#c22;font-weight:700">'
                            'ALERT FIRING: '
                            + html.escape(", ".join(sorted(active)))
                            + "</p>")
            obs_html += (
                "<h2>burn-rate alerts (perf/slo.json rules)</h2>"
                + badge_al
                + "<p>{} rule(s), {} tick(s) evaluated, {} fired "
                  "total</p>".format(
                      len(rules_cfg) or al.get("rules", "-"),
                      al.get("ticks", "-"), al.get("fired_total", "-"))
                + "<table><tr><th>rule</th><th>objective</th>"
                  "<th>severity</th><th>windows</th><th></th><th></th>"
                  "</tr>" + "".join(rows_al) + "</table>")
    # CFO: the failing-seed feed (reference: cfo.zig pushes failing
    # seeds to devhubdb; a green fleet is part of the dashboard).
    cfo_html = ""
    cfo = load_cfo(cfo_dir) if cfo_dir else None
    if cfo:
        failing = cfo.get("failing", [])
        cfo_html = (
            f"<h2>continuous fuzzing</h2>"
            f"<p>{html.escape(os.path.basename(cfo.get('_path', '')))}: "
            f"{html.escape(str(cfo.get('runs_clean', 0)))} clean, "
            f"{html.escape(str(cfo.get('runs_failing', 0)))} failing "
            f"({html.escape(str(cfo.get('elapsed_s', 0)))}s)</p>")
        if failing:
            items = "".join(
                "<li><code>{}</code> seed {} — <code>{}</code></li>".format(
                    html.escape(str(f.get("name"))),
                    html.escape(str(f.get("seed"))),
                    html.escape(str(f.get("reproduce", ""))))
                for f in failing[:50])
            cfo_html += f"<ol>{items}</ol>"
    badge = ("" if not regress else
             f'<p style="color:#c22;font-weight:700">'
             f'{len(regress)} metric(s) regressed vs trailing median</p>')
    doc = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>tigerbeetle-tpu-torch devhub</title>
<style>
body {{ font: 14px/1.5 system-ui, sans-serif; margin: 2rem; }}
table {{ border-collapse: collapse; }}
td {{ padding: .4rem 1rem; border-bottom: 1px solid #ddd; }}
</style></head><body>
<h1>tigerbeetle-tpu-torch devhub</h1>
<p>{len(entries)} recorded runs; latest metric values with history
sparklines (reference: devhub.tigerbeetle.com).</p>
{badge}{parity_html}
<table><tr><th>metric</th><th>latest</th><th>history</th><th></th></tr>
{''.join(rows)}
</table>
{fb_html}
{rec_html}
{route_html}
{stage_html}
{adm_html}
{ob_html}
{st_html}
{sh_html}
{dt_html}
{tr_html}
{slo_html}
{cp_html}
{wf_html}
{obs_html}
{cfo_html}
</body></html>"""
    with open(out_path, "w") as f:
        f.write(doc)
    return len(entries)
