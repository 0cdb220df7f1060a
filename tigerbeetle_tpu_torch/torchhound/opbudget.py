"""The op budget: heavy-op counts and operand bytes per dispatch tier,
pinned and checked.

The port's counterpart of the JAX package's `perf/opbudget.py`. Every
tier that torchhound's registry covers (`registry.py`, 18 entries) runs
once, eagerly, under the census (`core.trace`), under the JAX budget's
tier name where the JAX package has a counterpart:

  per_event_plain / per_event_imported   the per-event phase alone;
  plain, imported, fixpoint_8, fixpoint_deep_32, balancing_8,
  imported_fixpoint_8                    the per-batch tiers;
  super_plain_s4, super_deep24_s4        the superbatch tiers (and the
                                         port's ring and balancing
                                         forms, under their entry names);
  chain_w2 / _w8 / _w32, chain_body_w8   the chain window at three
                                         depths and one prepare's share
                                         (`core.window_body_census`);
  sharded_plain / _fixpoint              the replicated-state mesh steps;
  partitioned_plain / _fixpoint          the partitioned-state steps;
  partitioned_chain_w2 / _w8 / _w32,
  partitioned_chain_body                 the partitioned chain window.

A tier's census is its heavy aten ops by class (`core.HEAVY_CLASSES`,
collectives included) plus one `kernel` class: the calls of the
hand-written kernels' wrappers (`kernels`: probe and row gather). A
dispatch mode sees a wrapper's plain twin run on the CPU and nothing of
its kernel on the card, so the census pauses inside a wrapper on both
and counts the call as one kernel call either way: one pinned budget
holds on both devices. On the card every call is a launch, and `--check`
shows it (a tier whose launches differ from its kernel calls is red).

`--write [PATH]` pins `heavy_total`, the heavy classes and
`heavy_operand_bytes` per tier, plus a `telemetry` section (the pack's
lanes and aten ops, the chain body's heavy delta with telemetry on
against off, pinned at 0, and `overhead_ratio_max` 1.10, the JAX
package's), into the newest round, trace/opbudget_r01.json by default.
`--check` reds a tier above its pin and a telemetry census off its pin.
`--lint` runs core's lints over every traced tier: no closure constant
above CLOSURE_CONST_LIMIT, no host sync (`while_ops`), no collective part
above STATE_GATHER_LIMIT (`state_gathers`).

CLI: ``python -m tigerbeetle_tpu_torch.torchhound.opbudget [--check]
[--lint] [--write [PATH]] [--device cpu]`` (the card unless `--device`
is given; exit 1 on a red).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import core

# Chain census depths: the JAX package's. The body's share comes from
# the two of BODY_DEPTHS.
CHAIN_DEPTHS = (2, 8, 32)
BODY_DEPTHS = (2, 8)

# Registry entry -> tier name (the JAX budget's, where it has one).
TIER_NAMES = {
    "create_transfers_fast": "plain",
    "create_transfers_imported": "imported",
    "create_transfers_fixpoint": "fixpoint_8",
    "create_transfers_fixpoint_deep": "fixpoint_deep_32",
    "create_transfers_balancing": "balancing_8",
    "create_transfers_imported_fixpoint": "imported_fixpoint_8",
    "create_transfers_super": "super_plain_s4",
    "create_transfers_super_deep": "super_deep24_s4",
    "create_transfers_super_ring": "create_transfers_super_ring",
    "create_transfers_super_deep_ring": "create_transfers_super_deep_ring",
    "create_transfers_super_balancing": "create_transfers_super_balancing",
    "create_transfers_chain_ring": "create_transfers_chain_ring",
    "sharded_plain_step": "sharded_plain",
    "sharded_fixpoint_step": "sharded_fixpoint",
    "partitioned_plain_step": "partitioned_plain",
    "partitioned_fixpoint_step": "partitioned_fixpoint",
}
# Entries censused at CHAIN_DEPTHS under these prefixes, with a body.
CHAIN_TIERS = {"create_transfers_chain": ("chain_w", "chain_body_w8"),
               "partitioned_chain_step": ("partitioned_chain_w",
                                          "partitioned_chain_body")}

KERNEL_CLASS = "kernel"
OVERHEAD_RATIO_MAX = 1.10   # the JAX package's telemetry bound

_BUDGET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "trace")
DEFAULT_BUDGET_PATH = os.path.join(_BUDGET_DIR, "opbudget_r01.json")

NOTE = ("The port's op budget: every torchhound registry tier censused once, "
        "eagerly, on the CPU (python -m tigerbeetle_tpu_torch.torchhound."
        "opbudget --write --device cpu). heavy: aten heavy ops by class plus "
        "'kernel', the hand-written kernels' wrapper calls (a launch each on "
        "the card); heavy_operand_bytes: the operand bytes of the heavy ops "
        "and of the kernel calls. --check on the card holds the card's "
        "census to these pins.")


def tier_census(tr: core.Trace) -> dict:
    """A traced tier's budget census: core.heavy_census plus the kernel
    wrappers' calls as the `kernel` class and their operands' bytes in
    the operand bytes, as an aten heavy op's; `kernels` the calls by
    wrapper, `launches` the launches the card made (0 on the CPU)."""
    c = core.heavy_census(tr)
    calls = {k: tr.kernel_calls.get(k, 0) for k in ("ht_probe",
                                                    "row_gather")}
    c["heavy"][KERNEL_CLASS] = sum(calls.values())
    c["heavy_total"] += c["heavy"][KERNEL_CLASS]
    c["heavy_operand_bytes"] += tr.kernel_operand_bytes
    c["kernels"] = calls
    c["launches"] = dict(tr.launches)
    return c


def _per_event_calls(device):
    """The per-event phase's two tiers on the registry's flat operands:
    name -> (fn, args)."""
    import torch

    from ..ops import fast_kernels as FK
    from ..trace import profiler as PF
    from .registry import CAPS, N_PREPARE

    def args():
        ev, ts, n = PF._flat_operands(device, N_PREPARE)
        N = ev["id_lo"].shape[0]
        ts_vec = torch.full((N,), 1000, dtype=torch.int64, device=device)
        return PF._scratch_state(device, CAPS), ev, ts_vec

    def imported(state, ev, ts_vec):
        idxs = torch.arange(ts_vec.shape[0], dtype=torch.int64,
                            device=ts_vec.device)
        ctx = FK.imported_batch_ctx(state, ev, ts_vec, ev["valid"], idxs)
        return FK.per_event_status(state, ev, ts_vec, imported_ctx=ctx)

    return {"per_event_plain": (FK.per_event_status, args),
            "per_event_imported": (imported, args)}


def census_tiers(device=None, only=None, with_traces: bool = False):
    """tier name -> budget census for every tier, on `device` (None: the
    card). `only` restricts to a set of tier names. with_traces=True
    returns (censuses, tier name -> Trace) for the lints."""
    from ..ops.device import resolve_device
    from .registry import REP_DEPTH, entries

    device = resolve_device(device)
    out, traces = {}, {}

    def want(name):
        return only is None or name in only

    def run(name, fn, args):
        tr = core.trace(fn, *args)
        out[name] = tier_census(tr)
        traces[name] = tr

    for name, (fn, make) in _per_event_calls(device).items():
        if want(name):
            run(name, fn, make())
    for ename, entry in entries(device).items():
        if ename in CHAIN_TIERS:
            prefix, body = CHAIN_TIERS[ename]
            for w in CHAIN_DEPTHS:
                if want(f"{prefix}{w}") or (want(body) and w in BODY_DEPTHS):
                    run(f"{prefix}{w}", entry.fn, entry.make_args(w))
            if want(body):
                out[body] = core.window_body_census(
                    *(out[f"{prefix}{w}"] for w in BODY_DEPTHS[::-1]),
                    w_hi=BODY_DEPTHS[1], w_lo=BODY_DEPTHS[0])
            for w in CHAIN_DEPTHS:
                if not want(f"{prefix}{w}"):
                    out.pop(f"{prefix}{w}", None)
                    traces.pop(f"{prefix}{w}", None)
            continue
        tier = TIER_NAMES[ename]
        if want(tier):
            run(tier, entry.fn, entry.make_args(REP_DEPTH))
    return (out, traces) if with_traces else out


def telemetry_report(device=None, traces: dict | None = None) -> dict:
    """The telemetry plane of the partitioned chain at depths 8 and 2 on
    the registry's mesh: the pack's lanes, sites and aten ops
    (`core.telemetry_census`), and the chain body's heavy census with
    telemetry on against off (the pack is elementwise and one stack, so
    the pinned allowance is zero heavy ops). `traces`: census_tiers'
    traces, whose partitioned chain runs with telemetry on, reused."""
    from ..ops.device import resolve_device
    from ..parallel.partitioned import make_partitioned_chain_create_transfers
    from .registry import mesh_entries

    device = resolve_device(device)
    entry = mesh_entries(device)["partitioned_chain_step"]
    traces = traces or {}
    bodies, tel = {}, None
    for on in (True, False):
        step = make_partitioned_chain_create_transfers(entry.mesh, "plain",
                                                       telemetry=on)
        cens = {}
        for w in BODY_DEPTHS:
            tr = traces.get(f"partitioned_chain_w{w}") if on else None
            if tr is None:
                tr = core.trace(step, *entry.make_args(w))
            cens[w] = tier_census(tr)
            if on and w == BODY_DEPTHS[1]:
                tel = core.telemetry_census(tr)
        bodies[on] = core.window_body_census(
            cens[BODY_DEPTHS[1]], cens[BODY_DEPTHS[0]],
            w_hi=BODY_DEPTHS[1], w_lo=BODY_DEPTHS[0])["heavy_total"]
    return {"lanes": tel["lanes"], "pack_sites": tel["sites"],
            "pack_ops": tel["ops"], "chain_body_heavy_on": bodies[True],
            "chain_body_heavy_off": bodies[False],
            "chain_body_heavy_delta": bodies[True] - bodies[False]}


def load_budget() -> dict:
    """The committed budget: the newest trace/opbudget_r*.json."""
    with open(core.newest_budget_path()) as f:
        return json.load(f)


def check_telemetry(report: dict, committed: dict | None = None) -> list:
    """The telemetry census against the committed `telemetry` section:
    red when the pack's lanes differ, its aten ops grow, the pack is
    gone (a dead plane), or the chain body's heavy delta passes its
    allowance."""
    committed = committed if committed is not None else load_budget()
    budget = committed.get("telemetry")
    if budget is None:
        return ["the op budget has no 'telemetry' section (run --write)"]
    fails = []
    if report["lanes"] != budget["lanes"]:
        fails.append(f"telemetry lanes {report['lanes']} != committed "
                     f"{budget['lanes']} (TEL_LAYOUT changed without a "
                     "new budget round)")
    if report["pack_sites"] < 1:
        fails.append("telemetry pack missing from the partitioned chain "
                     "(dead telemetry plane)")
    if report["pack_ops"] > budget["pack_ops"]:
        fails.append(f"telemetry pack ops {report['pack_ops']} > committed "
                     f"{budget['pack_ops']} (compute smuggled into the "
                     "observability plane)")
    delta_max = budget.get("chain_body_heavy_delta_max", 0)
    if report["chain_body_heavy_delta"] > delta_max:
        fails.append(f"telemetry heavy-op delta "
                     f"{report['chain_body_heavy_delta']} > allowed "
                     f"{delta_max} (the telemetry block added heavy ops "
                     "to the chain body)")
    return fails


def check_budgets(current: dict, committed: dict | None = None,
                  on_card: bool = False) -> list:
    """The current census against the committed pins: red for a pinned
    tier without a census, and for any tier above its heavy_total, a
    class count or its operand bytes. on_card: also red for a tier whose
    launches differ from its kernel calls."""
    committed = committed if committed is not None else load_budget()
    fails = []
    for tier, budget in committed.get("budget", {}).items():
        cur = current.get(tier)
        if cur is None:
            fails.append(f"{tier}: no current census (tier removed? write "
                         "a new budget round)")
            continue
        if cur["heavy_total"] > budget["heavy_total"]:
            fails.append(f"{tier}: heavy_total {cur['heavy_total']} > "
                         f"budget {budget['heavy_total']}")
        for cls, limit in budget.get("heavy", {}).items():
            if cur["heavy"].get(cls, 0) > limit:
                fails.append(f"{tier}: {cls} count "
                             f"{cur['heavy'].get(cls, 0)} > budget {limit}")
        limit_b = budget.get("heavy_operand_bytes")
        if limit_b is not None and cur["heavy_operand_bytes"] > limit_b:
            fails.append(f"{tier}: heavy operand bytes "
                         f"{cur['heavy_operand_bytes']} > budget {limit_b}")
    if on_card:
        for tier, cur in current.items():
            if cur.get("launches", cur["kernels"]) != cur["kernels"]:
                fails.append(f"{tier}: launches {cur['launches']} != kernel "
                             f"calls {cur['kernels']}")
    return fails


def run_lints(traces: dict) -> list:
    """core's lints over every traced tier: closure constants, host syncs
    and whole-state collectives."""
    fails = []
    for tier, tr in traces.items():
        for label, size in core.closure_constants(tr):
            fails.append(f"{tier}: closure constant {label} = {size} B > "
                         f"{core.CLOSURE_CONST_LIMIT} B")
        if core.while_ops(tr):
            fails.append(f"{tier}: {core.while_ops(tr)} host sync(s) "
                         f"{tr.syncs[:3]} (a serving call must capture)")
        for name, nbytes in core.state_gathers(tr):
            fails.append(f"{tier}: {name} moves {nbytes} B a shard (> "
                         f"{core.STATE_GATHER_LIMIT} B: a whole-state "
                         "gather)")
    return fails


def build_budget(current: dict, tel_report: dict) -> dict:
    """The budget file's contents for `current` and `tel_report`."""
    return {
        "note": NOTE,
        "post": current,
        "budget": {t: {"heavy_total": c["heavy_total"],
                       "heavy": c["heavy"],
                       "heavy_operand_bytes": c["heavy_operand_bytes"]}
                   for t, c in current.items()},
        "telemetry": {"lanes": tel_report["lanes"],
                      "pack_ops": tel_report["pack_ops"],
                      "chain_body_heavy_delta_max": 0,
                      "overhead_ratio_max": OVERHEAD_RATIO_MAX},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tigerbeetle_tpu_torch.torchhound.opbudget",
        description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="fail when any tier exceeds its budget")
    ap.add_argument("--lint", action="store_true",
                    help="run the lints over every traced tier")
    ap.add_argument("--write", nargs="?", const=DEFAULT_BUDGET_PATH,
                    default=None, metavar="PATH",
                    help="pin the current census (default "
                         "trace/opbudget_r01.json)")
    ap.add_argument("--device", default=None,
                    help="where the tiers run (default: the card, CUDA)")
    args = ap.parse_args(argv)
    from ..ops.device import resolve_device

    device = resolve_device(args.device)
    current, traces = census_tiers(device, with_traces=True)
    for tier, c in current.items():
        print(f"{tier:34s} heavy={c['heavy_total']:4d} "
              + " ".join(f"{k}={v}" for k, v in c["heavy"].items())
              + f" operand_MB={c['heavy_operand_bytes'] / 1e6:.2f}"
              f" kernels={c['kernels']} launches={c.get('launches')}")
    tel = telemetry_report(device, traces)
    print(f"{'telemetry':34s} lanes={tel['lanes']} pack_ops="
          f"{tel['pack_ops']} sites={tel['pack_sites']} body_delta="
          f"{tel['chain_body_heavy_delta']}")
    rc = 0
    if args.write:
        with open(args.write, "w") as f:
            json.dump(build_budget(current, tel), f, indent=1,
                      sort_keys=True)
            f.write("\n")
        print(f"[opbudget] wrote {args.write}")
    if args.check:
        committed = load_budget()
        fails = (check_budgets(current, committed,
                               on_card=device.type == "cuda")
                 + check_telemetry(tel, committed))
        for f_ in fails:
            print(f"[opbudget] OVER BUDGET: {f_}")
        rc |= bool(fails)
        if not fails:
            print("[opbudget] within budget")
    if args.lint:
        fails = run_lints(traces)
        for f_ in fails:
            print(f"[opbudget] LINT: {f_}")
        rc |= bool(fails)
        if not fails:
            print("[opbudget] lints clean")
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
