"""Device-memory watermark plane: the static-allocation ledger.

Serving memory is statically allocated: every resident buffer is sized
by a cap chosen at startup, so the footprint is a function of caps, not
of history. This module makes that machine-checkable:

- ``measure_ledger(led)`` walks a live DeviceLedger and attributes every
  resident allocation to a named component: the state dict's top-level
  stores (accounts / transfers / events ring / both hash tables /
  scalars), the staged window pack in flight and, in the partitioned
  attach mode, the router's sharded state (``partitioned_state``, over
  all its shards) and its harvested telemetry block. Bytes come from shapes
  and dtypes (``numel() * element_size()``), deterministic on every
  device, with no allocator introspection.
- ``static_ledger(a_cap, t_cap, ...)`` predicts the same components from
  caps alone: it builds the ledger's `init_state` on the ``meta`` device
  (shapes, no storage), so the prediction can be held to the measured
  bytes; with ``partitioned_shards`` it adds the attach mode's
  ``partitioned_state`` and telemetry block on a mesh of that many
  shards.
- ``check_budget(measured, budget)`` compares a measurement with the
  committed budget: a component past its pinned bytes (beyond the
  budget's tolerance), a component the budget never pinned, or total
  growth is a RED.
- ``MemWatch`` emits the watermark as the catalog gauges
  ``memory_watermark_bytes`` / ``memory_budget_headroom_bytes`` and keeps
  the last observation and verdict for ``stats()``.
- ``device_memory_stats(led)`` reads the CUDA caching allocator
  (``torch.cuda.memory_stats``) under the JAX package's key names, and,
  given a ledger, the pools of its captured window graphs. Neither is a
  budget component: allocator memory is not a function of shapes, so the
  static ledger stays deterministic.

The port's state is laid out as the JAX package's (u64 lanes carried as
int64), so the ``state.*`` components equal its byte for byte. The staged
pack does not: the port packs a window as one int64 lane matrix (every
event lane, `valid` and the three seg lanes at 8 bytes each, the
ledger's `_pack_window`), where the JAX package stages each column at its
own width. So the port pins its own budget, ``membudget.json`` beside
this module, derived from ``static_ledger`` at the JAX package's caps and
tolerance (perf/membudget_r01.json) on its 8-shard mesh, with its
profiler overhead ceiling.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional

import torch

from .event import Event

# Worst-case staged-pack accounting: one pipelined window's lane matrix
# at STAGED_PACK_DEPTH prepares over the largest pad bucket.
STAGED_PACK_DEPTH = 2

DEFAULT_MEMBUDGET_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "membudget.json")


def leaf_bytes(leaf) -> int:
    """Resident bytes of one tensor (numel x element size; a 0-d tensor
    counts its dtype's width). Anything else counts 0."""
    if not isinstance(leaf, torch.Tensor):
        return 0
    return leaf.numel() * leaf.element_size()


def pytree_bytes(tree) -> int:
    """Total resident bytes of a nested dict / list / tuple of tensors."""
    if isinstance(tree, dict):
        return sum(pytree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_bytes(v) for v in tree)
    return leaf_bytes(tree)


def state_component_bytes(state) -> dict:
    """Bytes per top-level store of a ledger state dict. Nested stores
    are summed under their top key; bare scalar tensors are grouped
    under ``scalars``."""
    out: dict = {}
    scalars = 0
    for key, sub in state.items():
        if isinstance(sub, dict):
            out[f"state.{key}"] = pytree_bytes(sub)
        else:
            scalars += leaf_bytes(sub)
    out["state.scalars"] = scalars
    return out


def staged_pack_max_bytes(n_pad: int, depth: int = STAGED_PACK_DEPTH) -> int:
    """Worst-case bytes of one staged window pack: the lane matrix of
    `depth` prepares at `n_pad` lanes, measured from a real pack (the
    ledger's `fill_window`, what the stager writes into pinned memory),
    not a hand-kept formula."""
    import numpy as np

    from ..ops.batch import transfers_to_arrays
    from ..ops.ledger import _LANES, fill_window
    from ..types import Transfer

    ev = transfers_to_arrays([Transfer(id=1, debit_account_id=1,
                                       credit_account_id=2, amount=1,
                                       ledger=1, code=1)])
    lanes = np.zeros((len(_LANES), depth, n_pad), dtype=np.int64)
    fill_window(lanes, [ev] * depth, [1 + i for i in range(depth)], n_pad)
    return lanes.nbytes


def telemetry_block_bytes(n_shards: int, depth: int) -> int:
    """The harvested [n_shards, W, TEL_WORDS] u32 device-telemetry block
    of one partitioned chain window."""
    from ..parallel.partitioned import TEL_WORDS

    return n_shards * depth * TEL_WORDS * 4


def static_ledger(a_cap: int, t_cap: int, *, n_shards: int = 1,
                  window_depth: int = 8, n_pad: Optional[int] = None,
                  orphan_cap: Optional[int] = None,
                  e_cap: Optional[int] = None,
                  partitioned_shards: Optional[int] = None) -> dict:
    """The deterministic static-allocation ledger: predicted resident
    bytes per component from caps alone (the state built on the ``meta``
    device). For a partitioned mesh the per-shard caps divide by
    n_shards and components are global (x n_shards);
    ``per_device_bytes`` is the per-shard share. `partitioned_shards`:
    the ledger in the partitioned attach mode on a mesh of that many
    shards, which adds ``partitioned_state`` (the router's state at
    these caps, over all its shards: `parallel/partitioned.py`
    `static_partitioned_bytes`) and the telemetry block of a
    `window_depth` window."""
    from ..ops.ledger import N_PAD, init_state

    if n_pad is None:
        n_pad = N_PAD
    meta = torch.device("meta")
    if n_shards > 1:
        sub = init_state(a_cap // n_shards, t_cap // n_shards,
                         orphan_cap=(orphan_cap or (1 << 16)) // n_shards,
                         e_cap=None if e_cap is None else e_cap // n_shards,
                         device=meta)
        comps = {k: v * n_shards
                 for k, v in state_component_bytes(sub).items()}
    else:
        comps = state_component_bytes(init_state(
            a_cap, t_cap, orphan_cap=orphan_cap, e_cap=e_cap, device=meta))
    comps["staged_pack"] = staged_pack_max_bytes(n_pad)
    comps["telemetry_block"] = telemetry_block_bytes(
        n_shards, window_depth) if n_shards > 1 else 0
    if partitioned_shards:
        from ..parallel.partitioned import static_partitioned_bytes

        comps["partitioned_state"] = static_partitioned_bytes(
            a_cap, t_cap, partitioned_shards, e_cap)
        comps["telemetry_block"] = telemetry_block_bytes(
            partitioned_shards, window_depth)
    total = sum(comps.values())
    return {
        "caps": {"a_cap": a_cap, "t_cap": t_cap, "n_shards": n_shards,
                 "window_depth": window_depth, "n_pad": n_pad},
        "components": comps,
        "total_bytes": total,
        "per_device_bytes": total // max(1, n_shards),
    }


def measure_ledger(led) -> dict:
    """The live counterpart of static_ledger: component bytes measured
    from a DeviceLedger's resident tensors (its state, the staged window
    pack once the stager has packed it: `led._staged` is (prepares,
    timestamps, route, n_pad, future of (pack, ns)); in the partitioned
    attach mode the router's state over all its shards and the telemetry
    block of a window of STAGED_PACK_DEPTH prepares, as the JAX package
    counts it)."""
    comps = state_component_bytes(led.state)
    staged = getattr(led, "_staged", None)
    staged_b = 0
    if staged is not None:
        fut = staged[-1]
        if fut.done() and not fut.cancelled():
            try:
                payload, _ = fut.result()
                staged_b = pytree_bytes(payload)
            except Exception:
                staged_b = 0
    comps["staged_pack"] = staged_b
    router = getattr(led, "_part_router", None)
    n_shards = 1
    if router is not None:
        n_shards = router.n_shards
        pstate = getattr(led, "_part_state", None)
        if pstate is not None:
            comps["partitioned_state"] = pytree_bytes(pstate)
        comps["telemetry_block"] = telemetry_block_bytes(
            n_shards, STAGED_PACK_DEPTH)
    total = sum(comps.values())
    return {"components": comps, "total_bytes": total,
            "per_device_bytes": total // max(1, n_shards),
            "n_shards": n_shards}


def device_memory_stats(led=None) -> list:
    """Per-device allocator stats under the JAX package's names:
    ``bytes_in_use`` (allocated_bytes.all.current), ``peak_bytes_in_use``
    (allocated_bytes.all.peak), ``bytes_limit`` (the card's total memory,
    torch.cuda.mem_get_info) and ``largest_alloc_size`` where the
    allocator reports one. One dict per CUDA device; on a host without
    one, a single CPU entry with ``stats`` None. With `led`, its device's
    entry also carries ``graph_pools``: the bytes the caching allocator
    held before and after each window-graph capture, by key, and the
    graphs evicted (allocator memory, reported beside the stats, never a
    budget component)."""
    out = []
    if not torch.cuda.is_available():
        out.append({"device": "cpu", "platform": "cpu", "stats": None})
    else:
        for i in range(torch.cuda.device_count()):
            d = torch.device("cuda", i)
            stats = None
            try:
                s = torch.cuda.memory_stats(d)
                stats = {
                    "bytes_in_use": int(s.get("allocated_bytes.all.current",
                                              0)),
                    "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak",
                                                   0)),
                    "bytes_limit": int(torch.cuda.mem_get_info(d)[1]),
                }
                if "largest_alloc_size" in s:
                    stats["largest_alloc_size"] = int(s["largest_alloc_size"])
            except Exception:
                stats = None
            out.append({"device": str(d), "platform": "gpu", "stats": stats})
    if led is not None and getattr(led, "windows", None) is not None:
        wg = led.windows
        dev = wg.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        for entry in out:
            if entry["device"] == str(dev):
                entry["graph_pools"] = {
                    "reserved": {",".join(map(str, k)): list(v)
                                 for k, v in wg.reserved.items()},
                    "evictions": wg.evictions}
    return out


def check_budget(measured: dict, budget: dict) -> list:
    """Budget audit: measured components vs the committed budget. REDs on
    (a) any component past its pinned bytes beyond tolerance, (b) any
    component the budget never pinned (a leak shows up as a new
    allocation before it shows up as growth), (c) total growth. Returns
    human-readable RED lines (empty = green)."""
    tol = float(budget.get("tolerance", 0.02))
    pinned = budget.get("components", {})
    reds = []
    for comp, got in sorted(measured["components"].items()):
        limit = pinned.get(comp)
        if limit is None:
            if got:
                reds.append(
                    f"memwatch RED: component {comp!r} ({got} bytes) is "
                    f"not in the committed budget (new allocation — "
                    f"re-pin perf/membudget with --write if intended)")
            continue
        if got > math.ceil(limit * (1.0 + tol)):
            reds.append(
                f"memwatch RED: component {comp!r} grew to {got} bytes "
                f"vs pinned {limit} (tolerance {tol:.0%})")
    total, limit = measured["total_bytes"], budget.get("total_bytes")
    if limit is not None and total > math.ceil(limit * (1.0 + tol)):
        reds.append(
            f"memwatch RED: total watermark {total} bytes vs pinned "
            f"{limit} (tolerance {tol:.0%})")
    return reds


def load_budget(path: Optional[str] = None) -> dict:
    """The committed budget (default: the port's `membudget.json`)."""
    if path is None:
        path = DEFAULT_MEMBUDGET_PATH
    with open(path) as f:
        budget = json.load(f)
    for key in ("components", "total_bytes"):
        if key not in budget:
            raise ValueError(
                f"membudget {os.path.basename(str(path))} is missing "
                f"{key!r} — not a valid static-allocation budget")
    return budget


class MemWatch:
    """The watermark sampler the serving supervisor ticks: measures the
    static-allocation ledger, emits the catalog gauges, and keeps the
    last observation (+ budget verdict) for ``stats()``/devhub."""

    def __init__(self, tracer=None, budget_path: Optional[str] = None,
                 budget: Optional[dict] = None):
        from .tracer import NullTracer

        self.tracer = tracer if tracer is not None else NullTracer()
        self._budget_path = budget_path
        self._budget = budget
        self.observations = 0
        self.last: Optional[dict] = None
        self.reds: list = []

    @property
    def budget(self) -> Optional[dict]:
        if self._budget is None:
            try:
                self._budget = load_budget(self._budget_path)
            except (OSError, ValueError):
                self._budget = None
        return self._budget

    def observe(self, led, with_device_stats: bool = False) -> dict:
        """One watermark sample: measure, gauge, audit. Cheap (a walk
        over shapes), so the supervisor ticks it at every epoch
        verification."""
        rec = measure_ledger(led)
        self.observations += 1
        self.tracer.gauge(Event.memory_watermark_bytes,
                          rec["total_bytes"])
        budget = self.budget
        if budget is not None:
            rec["budget_total_bytes"] = budget["total_bytes"]
            rec["headroom_bytes"] = (budget["total_bytes"]
                                     - rec["total_bytes"])
            self.tracer.gauge(Event.memory_budget_headroom_bytes,
                              rec["headroom_bytes"])
            self.reds = check_budget(rec, budget)
            rec["budget_ok"] = not self.reds
        if with_device_stats:
            rec["device_memory_stats"] = device_memory_stats(led)
        self.last = rec
        return rec

    def stats(self) -> dict:
        return {"observations": self.observations,
                "last": self.last, "reds": list(self.reds)}
