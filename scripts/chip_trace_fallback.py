"""Card check of chip_smoke.py's window-trace fallback.

The profiler now and then drops device events from a trace. chip_smoke.py's
`window_trace` traces a committing window once and, where that trace lacks
the route's probe and row-gather kernels, traces poisoned replays of the
window's graph and keeps the fullest. This script runs the four phases whose
window traces take that fallback (the config-2 and config-4 windows, the
imported and the balancing phases) with the first trace of each such window
made to lose its probe kernels, so that every one of them passes only on a
replay's trace.

    python3 scripts/chip_trace_fallback.py

Needs one CUDA card. Prints the card line, then one JSON line: each window
trace's label, the traces it took and the kernel counts it kept. Exits
nonzero when a phase fails or a window kept its lossy first trace.
"""

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as CS  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_trace_fallback: no CUDA device", file=sys.stderr)
        return 2
    print(CS.card_line(), flush=True)
    dev = torch.device("cuda")
    CS.build_all()
    lose_next, kept = [], []
    trace_by_name, window_trace = CS._trace_by_name, CS.window_trace

    def lossy(dev_, fn) -> dict:
        got = trace_by_name(dev_, fn)
        if lose_next:
            lose_next.clear()
            got = {k: v for k, v in got.items() if "ht_probe_kernel" not in k}
        return got

    def first_trace_lossy(dev_, fn, label, replay=None, want=None, **kw):
        if replay is None:
            return window_trace(dev_, fn, label, **kw)
        lose_next.append(label)
        out = window_trace(dev_, fn, label, replay=replay, want=want, **kw)
        kept.append(dict(label=label, traces=out.get("traces"),
                         probes=out["probes"], gathers=out["gathers"]))
        return out

    CS._trace_by_name = lossy
    CS.window_trace = first_trace_lossy
    for phase in (CS.config2_window_phase, CS.config4_window_phase,
                  CS.imported_phase, CS.balancing_phase):
        phase(dev)
    print(json.dumps({"lossy_first_trace": kept}), flush=True)
    CS.check(len(kept) == 4 and all((k["traces"] or 0) >= 2 for k in kept),
             f"a window kept its lossy first trace: {kept}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
