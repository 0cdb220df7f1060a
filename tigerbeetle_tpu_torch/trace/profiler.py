"""Sampled per-dispatch profiling + the static roofline cost model.

The trace plane (spans, request trees) says how long a commit window
took; this module says where the device time goes and how far each
dispatch tier sits from what the card could do:

- ``DispatchProfiler`` wraps the serving dispatch thunks (chain / super
  / per-batch windows) with deterministic 1-in-N sampling. A sampled
  dispatch is timed on the host clock from before the thunk to the
  moment its device has finished every queued kernel
  (``torch.cuda.synchronize`` on the device the caller names: a result
  may hold only host tensors filled by asynchronous copies, or no tensor
  at all, so readiness is the device's, not the result's), in µs, into
  the ``dispatch_device_time`` catalog histogram by route and tier.
  Unsampled dispatches pay one integer increment.
- ``capture_once`` wraps the next sampled dispatch in a one-shot
  ``torch.profiler.profile`` (CPU activity, and CUDA where a card is
  present) and exports a Chrome trace into ``capture_dir``; a failure is
  recorded in ``capture_result`` with its reason.
- ``static_cost_model`` counts operations, FLOPs and device-memory
  bytes per dispatch tier by running one representative tier call on a
  scratch ledger under a counting dispatch mode, and
  ``roofline_fractions`` divides each tier's least time at the card's
  nominal peaks by its measured sampled dispatch time. A fraction means
  something only where the tier was costed at the shape its samples
  ran (``caps`` and ``batch``: the ledger's caps and events a prepare).

Nothing here runs device work of its own but the cost model's scratch
tier runs, whose kernel launches it reports apart (they are launches
like any other in the wrappers' LAUNCHES).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from .event import Event

# Nominal peak envelopes per platform: (FLOP/s, device-memory bytes/s).
# gpu: one NVIDIA H100 SXM5 80GB HBM3 at its 700 W power limit (NVIDIA's
# data sheet): 67 TFLOP/s in float32 outside the tensor cores (the tiers
# do integer and compare work, no matrix products) and 3.35 TB/s of HBM.
# A card set below 700 W runs under these. The cpu row is a round
# envelope so fractions stay comparable across CPU runs.
NOMINAL_PEAKS = {
    "gpu": (67e12, 3.35e12),
    "cpu": (100e9, 50e9),
}

# Representative tier call per dispatch tier: the cost model runs these,
# one per route (the partitioned chain on a mesh of more than one shard
# only, as the JAX package's registry skips it on small meshes).
TIER_ENTRIES = {
    "flat": "create_transfers_fast",
    "chain": "create_transfers_chain",
    "partitioned_chain": "make_partitioned_chain_create_transfers",
}

# The serving ledger's route names for each tier: the live dispatch
# labels windows "per_batch" where the flat tier serves them.
ROUTE_ALIASES = {
    "flat": ("flat", "per_batch"),
    "chain": ("chain",),
    "partitioned_chain": ("partitioned_chain",),
}

# Default scratch-ledger shapes of the representative calls (the JAX
# package's jaxhound registry fixtures): a_cap 2^10, t_cap 2^12,
# prepares of 1,024 over 63 accounts.
_SCRATCH_CAPS = (1 << 10, 1 << 12)
_N_CHAIN = 1024
_N_ACCOUNTS = 63


class DispatchProfiler:
    """Deterministic 1-in-N dispatch sampler feeding the
    ``dispatch_device_time`` histogram.

    ``time(thunk, route=..., tier=..., device=...)`` replaces a bare
    ``thunk()`` at the dispatch site. Sampling is a modular counter (no
    RNG: the serving path stays deterministic); a sampled call is timed
    until `device` has finished its queued work (None: nothing to wait
    for). The result is returned either way."""

    def __init__(self, tracer=None, sample_every: int = 8,
                 capture_dir: Optional[str] = None):
        from .tracer import NullTracer

        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, "
                             f"got {sample_every}")
        self.tracer = tracer if tracer is not None else NullTracer()
        self.sample_every = sample_every
        self.capture_dir = capture_dir
        self.dispatches = 0
        self.samples = 0
        self.last_us: Optional[float] = None
        # One-shot capture state: armed by capture_once(), consumed by
        # the next sampled dispatch.
        self._capture_armed = False
        self._prof = None
        self.capture_result: Optional[dict] = None

    def capture_once(self, capture_dir: Optional[str] = None) -> None:
        """Arm a one-shot ``torch.profiler`` trace around the next
        sampled dispatch. The Chrome trace's path (or the reason the
        capture failed) lands in ``capture_result``.

        Arm it only where the next sampled dispatch replays a window
        graph already captured (a key's third window on): profiling a
        CUDA-graph capture with CUPTI can fail or hang."""
        if capture_dir is not None:
            self.capture_dir = capture_dir
        self._capture_armed = True

    def time(self, thunk: Callable[[], object], *, route, tier,
             device=None):
        """Run one dispatch, sampled 1-in-N. Returns the thunk's result
        unchanged. `route`/`tier` may be strings or zero-arg callables
        (resolved after the thunk runs: the ledger knows a window's route
        once it has dispatched it). `device`: the device whose queued
        work a sampled dispatch waits for."""
        self.dispatches += 1
        if (self.dispatches - 1) % self.sample_every:
            return thunk()
        device = None if device is None else torch.device(device)
        cuda = device is not None and device.type == "cuda"
        capture = self._capture_armed
        if capture:
            self._capture_armed = False
            self._start_capture(cuda)
        t0 = time.perf_counter_ns()
        try:
            out = thunk()
            if cuda:
                torch.cuda.synchronize(device)
        finally:
            if capture:
                self._stop_capture()
        dt_us = (time.perf_counter_ns() - t0) / 1e3
        self.samples += 1
        self.last_us = dt_us
        self.tracer.observe(Event.dispatch_device_time, dt_us,
                            route=str(route() if callable(route)
                                      else route),
                            tier=str(tier() if callable(tier)
                                     else tier))
        return out

    def _start_capture(self, cuda: bool) -> None:
        if self.capture_dir is None:
            self.capture_result = {"ok": False,
                                   "reason": "no capture_dir set"}
            return
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self.capture_result = {"ok": True, "dir": self.capture_dir}
        except Exception as e:  # platform-dependent support
            self._prof = None
            self.capture_result = {
                "ok": False,
                "reason": f"{type(e).__name__}: {e} "
                          f"(deterministic timer fallback in effect)"}

    def _stop_capture(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        try:
            prof.__exit__(None, None, None)
            os.makedirs(self.capture_dir, exist_ok=True)
            path = os.path.join(self.capture_dir,
                                f"dispatch_{self.dispatches}.trace.json")
            prof.export_chrome_trace(path)
            self.capture_result = {"ok": True, "dir": self.capture_dir,
                                   "path": path}
        except Exception as e:
            self.capture_result = {"ok": False,
                                   "reason": f"stop: "
                                             f"{type(e).__name__}: {e}"}

    def stats(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "samples": self.samples,
            "sample_every": self.sample_every,
            "last_us": self.last_us,
            "capture": self.capture_result,
        }


# ------------------------------------------------------ static cost model

# aten ops that read rows of their first operand at indices: they move
# the rows they return and their indices, not the whole table (as XLA
# prices a gather).
_GATHER_OPS = frozenset(("index_select", "gather", "index", "take",
                         "embedding"))
# aten ops that write rows of their first operand in place at indices:
# they move their indices and values and the rows they write, at most
# as many bytes as they read (as XLA prices a scatter).
_SCATTER_OPS = frozenset((
    "index_put_", "_index_put_impl_", "index_copy_", "index_fill_",
    "index_add_", "scatter_", "scatter_add_", "scatter_reduce_",
    "masked_scatter_", "put_",
))

# aten ops charged one FLOP per output element: elementwise arithmetic,
# bitwise and compare ops, selects and reductions.
_FLOP_OPS = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "remainder",
    "floor_divide", "fmod", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "bitwise_left_shift", "bitwise_right_shift",
    "__and__", "__or__", "__xor__", "__lshift__", "__rshift__",
    "__ilshift__", "__irshift__", "__iand__", "__ior__", "__ixor__",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "maximum", "minimum",
    "clamp", "clamp_min", "clamp_max", "sign", "sum", "prod", "amax",
    "amin", "max", "min", "any", "all", "cumsum", "cummax", "cummin",
    "argmax", "argmin", "scatter_reduce", "scatter_add", "index_add",
))


def _tensor_bytes(tree) -> tuple:
    """(bytes, elements) of every tensor in a nested args/outputs tree
    (tensors inside lists, tuples and dicts, as pytree leaves)."""
    nbytes = numel = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            n = x.numel()
            nbytes += n * x.element_size()
            numel += n
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return nbytes, numel


_VIEWS: dict = {}


def _is_view(func) -> bool:
    """A view returns an alias of an input that it does not write: it
    moves no bytes."""
    v = _VIEWS.get(func)
    if v is None:
        v = _VIEWS[func] = any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return v


class _CostCounter:
    """The counting state of one representative tier run: aten ops, FLOPs
    and bytes through the dispatch mode, plus what the kernel wrappers
    charge (`kernel`), with counting paused while a wrapper runs (its
    plain twin, on the CPU, is not the kernel's work), and the mesh
    collectives (`collective`: `shard_utils.all_gather` and `psum` are
    Python functions, which a dispatch mode sees only as their copies and
    sums). `result` is what the counted call returned."""

    def __init__(self):
        self.ops = self.flops = self.op_bytes = 0
        self.kernel_bytes = self.kernel_operand_bytes = 0
        self.kernel_calls: dict = {}
        self.collectives: list = []
        self.paused = 0
        self.result = None

    def dispatch(self, func, args, kwargs):
        out = func(*args, **kwargs)
        if self.paused or _is_view(func):
            return out
        self.ops += 1
        name = func.overloadpacket.__name__
        b_out, n_out = _tensor_bytes(out)
        if name in _GATHER_OPS:
            b_idx, _ = _tensor_bytes((args[1:], kwargs))
            self.op_bytes += b_idx + 2 * b_out
        elif name in _SCATTER_OPS:
            b_rest, n_rest = _tensor_bytes((args[1:], kwargs))
            self.op_bytes += b_rest + min(b_rest, _tensor_bytes(args[0])[0])
            n_out = n_rest  # the values it combines, not the table
        else:
            b_in, _ = _tensor_bytes((args, kwargs))
            self.op_bytes += b_in + b_out
        if name in _FLOP_OPS or name.rstrip("_") in _FLOP_OPS:
            self.flops += n_out
        return out

    def kernel(self, name: str, fn, bound_bytes, *args):
        self.paused += 1
        try:
            out = fn(*args)
            self.kernel_bytes += bound_bytes(*args, out)
            self.kernel_operand_bytes += _tensor_bytes(args)[0]
        finally:
            self.paused -= 1
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        return out

    def collective(self, name: str, parts) -> None:
        """One mesh collective over `parts` (one tensor or dict of tensors
        a shard): its name, whether any operand is floating-point, the
        bytes of every part, of its largest part and of its largest
        tensor."""
        if self.paused:
            return
        from torch.utils._pytree import tree_leaves

        sizes = [_tensor_bytes(p)[0] for p in parts]
        leaves = [x for x in tree_leaves(list(parts))
                  if isinstance(x, torch.Tensor)]
        self.collectives.append(dict(
            name=name, bytes=sum(sizes), part_bytes=max(sizes, default=0),
            leaf_bytes=max((x.numel() * x.element_size() for x in leaves),
                           default=0),
            floating=any(x.is_floating_point() for x in leaves),
            dtypes=sorted({str(x.dtype) for x in leaves})))


def _count(fn, counter: _CostCounter):
    """Run fn() under a dispatch mode feeding `counter`, with the kernel
    wrappers' and the mesh collectives' cost hooks set; its result goes
    to `counter.result`. Returns how far the wrappers' LAUNCHES moved
    meanwhile {wrapper: n}: the run's launches where no other thread
    launches at the same time."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..ops import fused_probe, row_gather
    from ..parallel import shard_utils

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return counter.dispatch(func, args, kwargs or {})

    before = (fused_probe.LAUNCHES, row_gather.LAUNCHES)
    fused_probe.COST = row_gather.COST = shard_utils.COST = counter
    try:
        with Mode():
            counter.result = fn()
    finally:
        fused_probe.COST = row_gather.COST = shard_utils.COST = None
    return {"ht_probe": fused_probe.LAUNCHES - before[0],
            "row_gather": row_gather.LAUNCHES - before[1]}


def _chain_prepares(depth: int, n: int = _N_CHAIN, seed: int = 0):
    """`depth` uniform prepares of `n` transfers over 63 accounts (the JAX
    package's registry fixture at n = 1,024)."""
    import numpy as np

    from ..benchmark import _soa

    rng = np.random.default_rng(seed)
    evs, tss = [], []
    nid = 10 ** 6
    for b in range(depth):
        dr = rng.integers(1, 64, n, dtype=np.uint64)
        cr = (dr % 63) + 1
        evs.append(_soa(np.arange(nid, nid + n), dr, cr,
                        rng.integers(1, 100, n)))
        nid += n
        tss.append(10 ** 12 + b * (n + 10))
    return evs, tss


def _account_operands(device):
    """The 63 accounts' creation on `device`: (ev, timestamp, n) of
    create_accounts_fast, padded to their bucket."""
    from ..ops.batch import accounts_to_arrays
    from ..ops.ledger import _pad_bucket, events_to_device, pad_account_events
    from ..types import Account

    accounts = pad_account_events(accounts_to_arrays(
        [Account(id=i, ledger=1, code=1)
         for i in range(1, _N_ACCOUNTS + 1)]), n_pad=_pad_bucket(_N_ACCOUNTS))
    return events_to_device(accounts, device), 10 ** 9, _N_ACCOUNTS


def _scratch_state(device, caps: tuple) -> dict:
    """A fresh scratch ledger state at `caps` on `device` holding the 63
    accounts, so transfers post as a live window's do."""
    from ..ops import fast_kernels as FK
    from ..ops.ledger import init_state

    state, _ = FK.create_accounts_fast(init_state(*caps, device=device),
                                       *_account_operands(device))
    return state


def _flat_operands(device, batch: int) -> tuple:
    """One prepare of `batch` transfers on `device`, padded to its bucket:
    (ev, timestamp, n) of the flat tiers."""
    from ..ops.ledger import _pad_bucket, events_to_device, pad_transfer_events

    evs, tss = _chain_prepares(1, batch)
    ev = pad_transfer_events(evs[0], _pad_bucket(batch))
    return events_to_device(ev, device), tss[0], batch


def _chain_operands(depth: int, device, batch: int) -> tuple:
    """`depth` prepares of `batch` transfers stacked for the chain on
    `device`: (ev_stack, seg_stack)."""
    from ..ops.ledger import _pad_bucket, events_to_device, stack_chain_window

    evs, tss = _chain_prepares(depth, batch)
    ev_c, seg_c = stack_chain_window(evs, tss, _pad_bucket(batch))
    return events_to_device(ev_c, device), events_to_device(seg_c, device)


def _fixture_oracle():
    """An oracle holding the 63 accounts."""
    from ..oracle.state_machine import StateMachineOracle
    from ..types import Account

    sm = StateMachineOracle()
    sm.create_accounts([Account(id=i, ledger=1, code=1)
                        for i in range(1, _N_ACCOUNTS + 1)], 10 ** 9)
    return sm


def _partitioned_fixture(mesh, caps: tuple) -> tuple:
    """A router on `mesh` at `caps` and its state from an oracle holding
    the 63 accounts: (router, state)."""
    from ..parallel.partitioned import PartitionedRouter

    router = PartitionedRouter(mesh, a_cap=caps[0], t_cap=caps[1])
    return router, router.from_oracle(_fixture_oracle())


def _partitioned_state(mesh, caps: tuple, orphan_floor: int) -> tuple:
    """_partitioned_fixture's state with the orphan floor given too."""
    from ..parallel.partitioned import partitioned_from_oracle

    return partitioned_from_oracle(_fixture_oracle(), mesh, *caps,
                                   orphan_floor=orphan_floor)


def _partitioned_call(depth: int, mesh, caps: tuple, batch: int):
    """The partitioned chain's representative call: a router on `mesh` at
    `caps`, its state from an oracle holding the 63 accounts, `depth`
    prepares of `batch` transfers as one chain window's lane matrix."""
    from ..ops.ledger import _pad_bucket

    router, state = _partitioned_fixture(mesh, caps)
    evs, tss = _chain_prepares(depth, batch)
    lanes = router.stage_operands(evs, tss, _pad_bucket(batch)).to(
        mesh.distinct[0])
    step = router._chain_step("plain")
    return lambda: step.lanes(state, lanes)


def _tier_call(tier: str, depth: int, device, caps: tuple, batch: int,
               mesh=None):
    """A zero-argument representative call of `tier` on a fresh scratch
    ledger at `caps` on `device`: the flat tier on one prepare of `batch`
    transfers, the chain on `depth` of them, the partitioned chain on
    `depth` of them over `mesh`. The prepares' 63 accounts are created
    first, so the transfers post as a live window's do."""
    if tier == "partitioned_chain":
        return _partitioned_call(depth, mesh, caps, batch)
    from ..ops import fast_kernels as FK

    state = _scratch_state(device, caps)
    if tier == "flat":
        args = _flat_operands(device, batch)
        return lambda: FK.create_transfers_fast(state, *args)
    args = _chain_operands(depth, device, batch)
    return lambda: FK.create_transfers_chain(state, *args)


def static_cost_model(depth: int = 4, device=None,
                      caps: tuple = _SCRATCH_CAPS,
                      batch: int = _N_CHAIN, mesh=None) -> dict:
    """Operations, FLOPs and device-memory bytes per dispatch tier.

    For each tier of TIER_ENTRIES, one representative call (the flat
    tier on one prepare of `batch` transfers, the chain on `depth` such
    prepares) runs eagerly on a scratch ledger at `caps` on `device`
    (None: the card), never under a graph capture, inside a counting
    dispatch mode. Bytes are operand plus result bytes of each aten op
    that is not a view (XLA's "bytes accessed"), but a gather moves the
    rows it returns and its indices, and an in-place scatter its indices,
    its values and the rows it writes, not the whole table. To that come,
    for each hand-written kernel call, the bytes its PERF.md bound counts
    (the wrappers' `bound_bytes`: a dispatch mode does not see a kernel
    loaded through ops/_build.py). FLOPs are one per output element of
    each elementwise arithmetic, bitwise, compare, select or reduction
    op (a scatter's: one per value). A failure is recorded as
    ``unavailable``, never as zero. The partitioned chain tier runs on
    `mesh` (`shard_utils.Mesh`, `caps` dividing over its shards) and is
    skipped without one or on a mesh of one shard, as the JAX package
    skips it on small meshes."""
    from ..ops.device import resolve_device

    device = resolve_device(device)
    platform = "gpu" if device.type == "cuda" else "cpu"
    model: dict = {"platform": platform, "depth": depth,
                   "caps": tuple(caps), "batch": batch, "tiers": {}}
    for tier, entry_name in TIER_ENTRIES.items():
        if tier == "partitioned_chain" and (mesh is None or mesh.size < 2):
            continue
        counter = _CostCounter()
        try:
            call = _tier_call(tier, depth, device, caps, batch, mesh)
            launches = _count(call, counter)
        except Exception as e:
            model["tiers"][tier] = {
                "entry": entry_name,
                "unavailable": f"{type(e).__name__}: {e}"}
            continue
        row = {
            "entry": entry_name,
            "route": tier,
            "instructions": counter.ops,
            "flops": counter.flops,
            "hbm_bytes": counter.op_bytes + counter.kernel_bytes,
            "kernel_bytes": counter.kernel_bytes,
            "kernel_calls": dict(counter.kernel_calls),
            "launches": launches,
        }
        rs = roofline_seconds(row["flops"], row["hbm_bytes"], platform)
        if rs is not None:
            row["roofline_seconds"] = rs
        model["tiers"][tier] = row
    return model


def roofline_seconds(flops, hbm_bytes, platform: str) -> Optional[float]:
    """Least seconds for one dispatch under the nominal peaks: max of the
    compute limit and the bandwidth limit. None when the cost model gave
    nothing (never a fabricated 0-second roofline)."""
    peaks = NOMINAL_PEAKS.get(platform)
    if peaks is None or not flops and not hbm_bytes:
        return None
    peak_flops, peak_bw = peaks
    return max((flops or 0.0) / peak_flops,
               (hbm_bytes or 0.0) / peak_bw)


def measured_dispatch_us(tracer) -> dict:
    """Per-series sampled dispatch summaries from a recording tracer:
    series key -> {route, tier, count, p50_us, p99_us, max_us}. Series
    keys follow the tracer's hist_tags projection
    (``dispatch_device_time|route:...,tier:...``)."""
    out: dict = {}
    series = getattr(tracer, "histogram_series", None)
    if not series:
        return out
    for key, (name, tags) in series.items():
        if name != Event.dispatch_device_time.name:
            continue
        h = tracer.histograms[key]
        s = h.summary()
        out[key] = {
            "route": tags.get("route"),
            "tier": tags.get("tier"),
            "count": s.get("count"),
            "p50_us": h.quantile(0.5),
            "p99_us": h.quantile(0.99),
            "max_us": s.get("max"),
        }
    return out


def roofline_fractions(cost_model: dict, measured: dict) -> dict:
    """Achieved-vs-roofline fraction per tier: roofline seconds over
    the measured sampled-dispatch p50 (1.0 = at the nominal wall).
    ``measured`` is ``measured_dispatch_us``'s output; routes are
    matched tier->route via the cost model rows."""
    out: dict = {}
    for tier, row in cost_model.get("tiers", {}).items():
        rs = row.get("roofline_seconds")
        if rs is None:
            continue
        route = row.get("route")
        accepted = ROUTE_ALIASES.get(route, (route,))
        p50s = [m["p50_us"] for m in measured.values()
                if m.get("route") in accepted and m.get("count")]
        if not p50s:
            continue
        measured_s = min(p50s) / 1e6  # best tier sample: the fastest
        if measured_s <= 0:
            continue
        out[tier] = {
            "route": route,
            "roofline_seconds": rs,
            "measured_p50_s": measured_s,
            "fraction": rs / measured_s,
        }
    return out


def profile_probe(tracer=None, profiler: Optional[DispatchProfiler] = None,
                  depth: int = 4, device=None, caps: tuple = _SCRATCH_CAPS,
                  batch: int = _N_CHAIN, mesh=None) -> dict:
    """The ``profile`` record: static cost model (at `depth`, `caps` and
    `batch`: give it the shape the sampled windows ran) + measured
    sampled-dispatch histograms + achieved-vs-roofline fractions per
    tier + sampler counters. Beyond the cost model's scratch runs, pure
    assembly over state the run already produced."""
    cost_model = static_cost_model(depth=depth, device=device, caps=caps,
                                   batch=batch, mesh=mesh)
    measured = measured_dispatch_us(tracer) if tracer is not None else {}
    out = {
        "cost_model": cost_model,
        "dispatch_device_time": measured,
        "roofline": roofline_fractions(cost_model, measured),
    }
    if profiler is not None:
        out["sampler"] = profiler.stats()
    return out
