"""Burn-rate alert rules over the SLO objectives: perf/slo.json's
``alerts`` section, parsed and checked against its own objectives.

Each rule watches one declared objective and fires SRE-style, when both
a fast and a slow burn window exceed their burn thresholds (Google SRE
workbook ch.5, in commit-window ticks). A rule naming an objective that
perf/slo.json does not declare, an unknown severity, inverted windows or
a missing runbook anchor is a load-time ValueError.

The part of the JAX package's `trace/alerts.py` that the port's devhub
reads (its burn-rate panel lists the declared rules): `AlertRule` and
`load_alert_rules`, copied. The alert engine itself is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .slo import DEFAULT_SLO_PATH, load_objectives

SEVERITIES = ("page", "ticket")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One burn-rate rule over a declared SLO objective."""

    name: str
    objective: str           # perf/slo.json objective name
    fast_window: int         # ticks; the cliff detector
    slow_window: int         # ticks; the blip filter (> fast_window)
    fast_burn: float         # breach fraction to trip the fast window
    slow_burn: float         # breach fraction to trip the slow window
    severity: str = "ticket"  # page | ticket
    hysteresis: int = 8      # healthy known ticks to resolve
    runbook: str = ""        # anchor into docs/operating/monitoring.md
    doc: str = ""


def load_alert_rules(path: Optional[str] = None) -> dict:
    """Parse perf/slo.json's ``alerts`` section against its own
    objectives. Returns {"rules": [AlertRule...], "objectives":
    {name: Objective}}. A rule referencing an undeclared objective, an
    unknown severity, or inverted windows is a ValueError — the
    dead-rule RED the gate's profile leg proves."""
    import json

    path = path or DEFAULT_SLO_PATH
    loaded = load_objectives(path)
    by_name = {o.name: o for o in loaded["objectives"]}
    with open(path) as f:
        raw = json.load(f)
    rules = []
    seen = set()
    for r in raw.get("alerts", []):
        name = r.get("name")
        if not name or name in seen:
            raise ValueError(
                f"slo.json alerts: missing/duplicate rule name {name!r}")
        seen.add(name)
        obj = r.get("objective")
        if obj not in by_name:
            raise ValueError(
                f"slo.json alert {name!r}: objective {obj!r} is not "
                f"declared in {sorted(by_name)} — a dead rule nothing "
                f"can ever evaluate")
        sev = r.get("severity", "ticket")
        if sev not in SEVERITIES:
            raise ValueError(
                f"slo.json alert {name!r}: severity {sev!r} not in "
                f"{SEVERITIES}")
        fast_w = int(r.get("fast_window", 8))
        slow_w = int(r.get("slow_window", 32))
        if not 0 < fast_w < slow_w:
            raise ValueError(
                f"slo.json alert {name!r}: windows must satisfy "
                f"0 < fast ({fast_w}) < slow ({slow_w})")
        fast_b = float(r.get("fast_burn", 0.5))
        slow_b = float(r.get("slow_burn", 0.25))
        for label, b in (("fast_burn", fast_b), ("slow_burn", slow_b)):
            if not 0.0 < b <= 1.0:
                raise ValueError(
                    f"slo.json alert {name!r}: {label} {b} not in (0, 1]")
        if not r.get("runbook"):
            raise ValueError(
                f"slo.json alert {name!r}: a rule must carry a runbook "
                f"anchor (docs/operating/monitoring.md#...)")
        rules.append(AlertRule(
            name=name, objective=obj, fast_window=fast_w,
            slow_window=slow_w, fast_burn=fast_b, slow_burn=slow_b,
            severity=sev, hysteresis=int(r.get("hysteresis", 8)),
            runbook=str(r["runbook"]), doc=r.get("doc", "")))
    return {"rules": rules, "objectives": by_name}
