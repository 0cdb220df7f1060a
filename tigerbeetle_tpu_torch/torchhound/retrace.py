"""Capture auditor: the closed signature set of the dispatch routes, pinned.

The port's counterpart of the JAX package's `jaxhound/retrace.py`. In
the JAX package every distinct abstract signature of an entry is one
more XLA compile; in the port a window route runs as a CUDA graph
captured once a `WindowGraphs` key (route, W, n_pad), so every distinct
signature a route is called with is one more capture and one more graph
pool held on the card (`ops/window_graph.py`). The dispatch layer pads
batches into PAD_BUCKETS and stacks windows so the set stays closed:
small, enumerable, flat in window depth W but for the window axis
itself. This auditor makes that a committed artifact:

  - For every registry entry it drives `make_args` across the window
    matrix W in {1, 2, 8, 32} (the real stacking and padding drivers)
    and takes the signature (shape, dtype, weak) of every argument leaf
    at each depth; a Python scalar is weak, as in the JAX package's type
    promotion and PyTorch's. The per-depth signatures unify into one
    canonical signature: an axis that varies with W must equal W
    (normalized to "W"); any other variation — a dtype drifting with
    depth, a Python scalar at one depth only, an axis scaling with
    something else — is a polymorphic call, a capture a depth the
    route's design forbids. RED.
  - The canonical set is pinned in trace/tracebudget_r*.json (append a
    round to move a pin; `core.newest_tracebudget_path` resolves the
    head). `check_budget` re-derives it and compares count and digest
    per entry.
  - A live capture probe (`capture_probe`) on one `DeviceLedger`: three
    windows at one key run eagerly once, are captured once and then
    replay with no new capture; a window at another W is a new key; no
    graph is dropped, so the state's storage stayed put.
  - The counterpart of the weak-typed scan carry (`weak_carries`): every
    state leaf's shape, dtype and storage are the same after one call as
    before (a graph reads and writes those storages), and the poison
    carry the routes thread is a bool tensor, 0-dim a prepare.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ..ops.window_graph import _tensors as _leaves
from .core import newest_tracebudget_path


def leaf_signature(args) -> list[tuple]:
    """(shape, dtype, weak) per argument leaf (dicts in key order): a
    tensor's or array's shape and dtype, a Python scalar's type (weak),
    None as "None"."""
    out = []
    for x in _leaves(args):
        if isinstance(x, torch.Tensor):
            out.append((tuple(int(d) for d in x.shape),
                        str(x.dtype).replace("torch.", ""), False))
        elif isinstance(x, (np.ndarray, np.generic)):
            out.append((tuple(int(d) for d in np.shape(x)),
                        str(np.asarray(x).dtype), False))
        elif isinstance(x, (bool, int, float)):
            out.append(((), {bool: "bool", int: "int64",
                             float: "float64"}[type(x)], True))
        elif x is None:
            out.append(((), "None", False))
        else:
            out.append(((), type(x).__name__, False))
    return out


def canonical_signature(entry) -> tuple[list, list[str]]:
    """Unify an entry's per-depth signatures into one canonical
    signature (window axes -> "W"); the second element lists
    polymorphic-call findings (non-empty = RED)."""
    sigs = {d: leaf_signature(entry.make_args(d)) for d in entry.depths}
    depths = list(entry.depths)
    findings: list[str] = []
    n_leaves = {len(s) for s in sigs.values()}
    if len(n_leaves) != 1:
        return [], [
            f"polymorphic_tree: leaf count varies across depths "
            f"({ {d: len(s) for d, s in sigs.items()} }) — the argument "
            "tree itself depends on W"]
    canon = []
    for i in range(n_leaves.pop()):
        shapes = [sigs[d][i][0] for d in depths]
        dtypes = {sigs[d][i][1] for d in depths}
        weaks = {sigs[d][i][2] for d in depths}
        if len(dtypes) > 1:
            findings.append(
                f"polymorphic_dtype: leaf {i} dtype varies with W "
                f"({sorted(dtypes)}) — one capture per depth")
        if len(weaks) > 1:
            findings.append(
                f"weak_type_leak: leaf {i} is a Python scalar at some "
                "depths only")
        ranks = {len(s) for s in shapes}
        if len(ranks) > 1:
            findings.append(
                f"polymorphic_shape: leaf {i} rank varies with W")
            canon.append(("<polymorphic>", sorted(dtypes)[0], False))
            continue
        cshape = []
        for ax in range(ranks.pop()):
            vals = [s[ax] for s in shapes]
            if len(set(vals)) == 1:
                cshape.append(vals[0])
            elif vals == depths:
                cshape.append("W")
            else:
                findings.append(
                    f"polymorphic_shape: leaf {i} axis {ax} varies "
                    f"with W but not AS W ({dict(zip(depths, vals))}) "
                    "— an un-normalized data-dependent dimension")
                cshape.append("?")
        canon.append((tuple(cshape), sorted(dtypes)[0],
                      sorted(weaks)[0]))
    return canon, findings


def signature_digest(canon: list) -> str:
    """Stable short digest of a canonical signature."""
    return hashlib.sha256(repr(canon).encode()).hexdigest()[:16]


def _fallback_of(result):
    if isinstance(result, tuple) and len(result) == 2:
        result = result[1]
    return result.get("fallback") if isinstance(result, dict) else None


def weak_carries(tr, name: str = "entry", route: str = "flat") -> list[str]:
    """The state and the poison carry of one traced call (`core.Trace`):
    every state leaf keeps its shape, dtype and storage, and the call's
    fallback flag — the poison the next prepare or window reads — is a
    bool tensor, 0-dim (one a prepare, stacked, on a chain route). Empty
    = clean."""
    fails: list[str] = []
    if len(tr.state_before) != len(tr.state_after):
        fails.append(f"{name}: weak_carry: the state has "
                     f"{len(tr.state_after)} leaves after the call, "
                     f"{len(tr.state_before)} before")
    for i, (b, a) in enumerate(zip(tr.state_before, tr.state_after)):
        if b != a:
            fails.append(
                f"{name}: weak_carry: state leaf {i} {b[1]}{list(b[0])} "
                f"became {a[1]}{list(a[0])}"
                + (" in new storage" if a[2] != b[2] else "")
                + " — a captured graph would read a stale tensor")
    fb = _fallback_of(tr.result)
    chained = route in ("chain", "partitioned_chain")
    if fb is not None and not (
            isinstance(fb, torch.Tensor) and fb.dtype == torch.bool
            and fb.dim() == (1 if chained else 0)):
        what = (f"{fb.dtype}{list(fb.shape)}"
                if isinstance(fb, torch.Tensor) else type(fb).__name__)
        fails.append(
            f"{name}: weak_carry: the poison carry is {what}, not a "
            "0-dim bool a prepare — a Python value or another dtype in "
            "the carry reads back on the host or recaptures")
    return fails


def audit(entries: dict) -> tuple[dict, list[str]]:
    """Canonical signatures + polymorphism findings for a registry.
    Returns ({entry: {"route", "depths", "n_signatures", "n_leaves",
    "digest"}}, RED strings)."""
    table = {}
    fails: list[str] = []
    for name, entry in entries.items():
        canon, findings = canonical_signature(entry)
        fails.extend(f"{name}: {f}" for f in findings)
        table[name] = {
            "route": entry.route,
            "depths": list(entry.depths),
            "n_signatures": 1,
            "n_leaves": len(canon),
            "digest": signature_digest(canon),
        }
    return table, fails


def check_budget(entries: dict, budget_path: str | None = None,
                 table: dict | None = None) -> list[str]:
    """Current canonical-signature table vs the committed
    tracebudget_r*.json head. Any drift — a new entry, a vanished
    entry, a digest change, a signature-count change — is a RED whose
    fix is an explicit reviewed commit of a new round."""
    if budget_path is None:
        budget_path = newest_tracebudget_path()
    with open(budget_path) as f:
        committed = json.load(f)
    pinned = committed.get("entries", {})
    if table is None:
        table, fails = audit(entries)
    else:
        fails = []
    base = os.path.basename(budget_path)
    for name, cur in table.items():
        pin = pinned.get(name)
        if pin is None:
            fails.append(
                f"{name}: not pinned in {base} — new dispatch entry "
                "needs a committed tracebudget round")
            continue
        if cur["n_signatures"] > pin["n_signatures"]:
            fails.append(
                f"{name}: {cur['n_signatures']} signatures > pinned "
                f"{pin['n_signatures']} in {base}")
        if cur["digest"] != pin["digest"]:
            fails.append(
                f"{name}: canonical signature digest {cur['digest']} "
                f"!= pinned {pin['digest']} in {base} (the entry's "
                "call signature changed — if intended, commit a new "
                "tracebudget round)")
    for name in pinned:
        if name not in table:
            fails.append(
                f"{name}: pinned in {base} but missing from the "
                "registry (entry removed? commit a new round)")
    return fails


def write_budget(entries: dict, path: str) -> dict:
    """Derive the canonical table and write it as a tracebudget round
    (the explicit, reviewed act of moving a pin)."""
    table, fails = audit(entries)
    if fails:
        raise RuntimeError(
            "refusing to pin a polymorphic matrix:\n  " +
            "\n  ".join(fails))
    doc = {
        "round": int(os.path.basename(path).split("_r")[1][:2])
        if "_r" in path else 1,
        "matrix": {"depths": list(
            max((e.depths for e in entries.values()), key=len))},
        "entries": table,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def capture_probe(device=None, caps: tuple | None = None,
                  batch: int = 1024, widths: tuple = (4, 8),
                  routes: tuple = ("chain", "super")) -> tuple[dict, list]:
    """Live capture probe on one `DeviceLedger` on `device` (None: the
    card) at `caps` (None: its defaults) holding 63 accounts. For each
    route (chain: `create_transfers_window`; super: the same with
    all_or_nothing) three windows of widths[0] prepares of `batch`
    uniform transfers, then one of widths[1]. On the card the first
    key's windows must run eager 1, captured 1 (its replay right after),
    then replay with no new capture, and the second key's first window
    eagerly; on the CPU every window runs eagerly, so the eager counts
    and the key set are checked. Every window must commit whole on its
    route, and no graph may be dropped (the state's storage stayed put).
    Returns ({key: counts, "drops", "launches"}, RED strings)."""
    from ..ops import fused_probe, row_gather
    from ..ops.device import resolve_device
    from ..ops.ledger import DeviceLedger, _pad_bucket
    from ..trace.profiler import _N_ACCOUNTS, _chain_prepares
    from ..types import Account, CreateTransferStatus

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    led = (DeviceLedger(device=dev) if caps is None
           else DeviceLedger(*caps, device=dev))
    led.create_accounts([Account(id=i, ledger=1, code=1)
                         for i in range(1, _N_ACCOUNTS + 1)], 10 ** 9)
    w0, w1 = widths
    evs, tss = _chain_prepares(len(routes) * (3 * w0 + w1), batch)
    pos = 0
    fails: list[str] = []
    n_pad = _pad_bucket(batch)
    created = int(CreateTransferStatus.created)
    launches = (fused_probe.LAUNCHES, row_gather.LAUNCHES)
    wg = led.windows

    def counts(key) -> tuple:
        return (wg.eager.get(key, 0), wg.captures.get(key, 0),
                wg.replays.get(key, 0))

    for route in routes:
        keys = ((route, w0, n_pad), (route, w1, n_pad))
        want = ([(1, 0, 0), (1, 1, 1), (1, 1, 2), (1, 1, 2)] if cuda else
                [(1, 0, 0), (2, 0, 0), (3, 0, 0), (3, 0, 0)])
        for i, w in enumerate((w0, w0, w0, w1)):
            ev_w, ts_w = evs[pos:pos + w], tss[pos:pos + w]
            pos += w
            res = led.create_transfers_window(
                ev_w, ts_w, all_or_nothing=route != "chain")
            if res is None or led.last_window_route != route or any(
                    (np.asarray(st) != created).any() for st, _ in res):
                fails.append(
                    f"capture_probe: {route} window {i} of {w} did not "
                    f"commit whole on its route "
                    f"(ran {led.last_window_route})")
            got = counts(keys[0])
            if got != want[i]:
                fails.append(
                    f"capture_probe: {route} key {keys[0]} after window "
                    f"{i}: (eager, captures, replays) {got}, expected "
                    f"{want[i]}")
        if counts(keys[1]) != (1, 0, 0):
            fails.append(
                f"capture_probe: {route} key {keys[1]}: (eager, captures, "
                f"replays) {counts(keys[1])}, expected (1, 0, 0): a "
                "window at another W is one new key")
    expect_keys = {(r, w, n_pad) for r in routes for w in widths}
    if set(wg.eager) != expect_keys:
        fails.append(f"capture_probe: keys {sorted(wg.eager)}, expected "
                     f"{sorted(expect_keys)}")
    if wg.drops:
        fails.append(f"capture_probe: {wg.drops} graph drops — a state "
                     "storage moved between windows")
    out = {repr(k): dict(zip(("eager", "captures", "replays"), counts(k)))
           for k in sorted(expect_keys)}
    out["drops"] = wg.drops
    out["launches"] = {"ht_probe": fused_probe.LAUNCHES - launches[0],
                       "row_gather": row_gather.LAUNCHES - launches[1]}
    out["device"] = str(dev)
    led.release()
    return out, fails
