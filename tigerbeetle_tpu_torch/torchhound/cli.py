"""torchhound CLI: run the census report or any static pass standalone.

    python -m tigerbeetle_tpu_torch.torchhound                    # report
    python -m tigerbeetle_tpu_torch.torchhound --kernel K         # one
    python -m tigerbeetle_tpu_torch.torchhound --pass determinism # a pass
    python -m tigerbeetle_tpu_torch.torchhound --pass all --json --device cpu

Passes run over the full serving-entry registry (registry.entries), on
the card unless `--device cpu` is given; the mesh entries run on 8
logical shards of that device. Exit status is nonzero when any pass
REDs — the same verdict the gate's `static` leg enforces, runnable in
isolation by an operator chasing one finding. `--write-tracebudget
PATH` derives and writes a new capture-budget round (the explicit act of
moving a pin).
"""

from __future__ import annotations

import argparse
import json as _json
import os
import sys

PASSES = ("determinism", "host", "retrace", "sharding")

# The capture probe off the card: a small ledger, small prepares.
CPU_CAPTURE = dict(caps=(1 << 10, 1 << 13), batch=128)


def run_passes(which: str, write_tracebudget: str | None = None,
               device=None) -> tuple[dict, dict]:
    """Run the selected passes (`which`: a name of PASSES or "all") over
    the registry on `device` (None: the card). Returns (pass name -> list
    of RED strings, what the passes saw: "entries", and where they ran
    "traces" (name -> census trace), "table" and "tracebudget" (the
    signature audit's canonical table and the budget file's name) and
    "capture" (the live capture probe's counters))."""
    from ..ops.device import resolve_device
    from . import determinism, hostdet, registry, retrace, shardspec

    device = resolve_device(device)
    selected = PASSES if which == "all" else (which,)
    out: dict[str, list[str]] = {}
    seen: dict = {}

    def _entries():
        if "entries" not in seen:
            seen["entries"] = registry.entries(device)
        return seen["entries"]

    def _traces():
        if "traces" not in seen:
            seen["traces"] = {n: e.trace() for n, e in _entries().items()}
        return seen["traces"]

    if "determinism" in selected:
        out["determinism"] = determinism.run(_traces())
    if "host" in selected:
        out["host"] = hostdet.run()
    if "retrace" in selected:
        fails: list[str] = []
        if write_tracebudget:
            retrace.write_budget(_entries(), write_tracebudget)
            print(f"[torchhound] wrote {write_tracebudget}")
        else:
            seen["table"], audit_fails = retrace.audit(_entries())
            fails.extend(audit_fails)
            try:
                fails.extend(retrace.check_budget(
                    _entries(), table=seen["table"]))
                seen["tracebudget"] = os.path.basename(
                    retrace.newest_tracebudget_path())
            except FileNotFoundError as e:
                fails.append(f"tracebudget: {e}")
                seen["tracebudget"] = None
        for name, tr in _traces().items():
            fails.extend(retrace.weak_carries(
                tr, name, _entries()[name].route))
        seen["capture"], capture_fails = retrace.capture_probe(
            device, **({} if device.type == "cuda" else CPU_CAPTURE))
        fails.extend(capture_fails)
        out["retrace"] = fails
    if "sharding" in selected:
        out["sharding"] = shardspec.run(_entries(), seen.get("traces"))
    return out, seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tigerbeetle_tpu_torch.torchhound",
        description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default=None,
                    help="restrict the census report to one kernel")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--pass", dest="which", default=None,
                    choices=PASSES + ("all",),
                    help="run a static pass over the serving-entry "
                         "registry instead of the census report")
    ap.add_argument("--write-tracebudget", default=None, metavar="PATH",
                    help="derive and write a new tracebudget round "
                         "(with --pass retrace)")
    ap.add_argument("--device", default=None,
                    help="where the entries run (default: the card, CUDA; "
                         "cpu on a machine without one)")
    args = ap.parse_args(argv)
    from ..ops.device import resolve_device

    device = resolve_device(args.device)

    if args.which is None:
        from .core import report

        lines = report(args.kernel, device)
        if args.json:
            print(_json.dumps({"report": lines}, indent=1))
        else:
            print("\n".join(lines))
        return 0

    results, _ = run_passes(args.which, args.write_tracebudget, device)
    if args.json:
        print(_json.dumps(
            {"passes": {k: {"ok": not v, "findings": v}
                        for k, v in results.items()}}, indent=1))
    else:
        for name, fails in results.items():
            print(f"[torchhound] pass {name}: "
                  + ("clean" if not fails else f"{len(fails)} RED"))
            for f in fails:
                print(f"  RED {f}")
    return 1 if any(results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
