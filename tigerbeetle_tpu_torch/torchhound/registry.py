"""Serving-entry registry: every dispatch entry the static passes audit.

The port's counterpart of the JAX package's `jaxhound/registry.py`. One
place enumerates the dispatch surface — the flat per-batch and
superbatch tiers, the chain route, the replicated sharded steps, the
partitioned (account-hash-sharded) steps and the partitioned chain — so
a pass added once runs over all of them, and a route added without an
entry here is a visible gap.

The fixtures are the JAX registry's sizes, built by the observatory's
cost model (`trace/profiler.py`): caps 2^10 / 2^12, 63 accounts created
first, prepares of 1,024 uniform transfers over them, superbatches of
4 x 1,024, the chain and the partitioned chain at REP_DEPTH prepares.
The mesh entries run on `Mesh([device] * 8)`: eight logical shards on
one device, as the port's tests run them, so unlike the JAX registry
they do not depend on how many devices there are.

Each Entry carries thunks, not tensors: nothing is built until a pass
asks. `make_args(depth)` builds fresh inputs on the registry's device at
window depth W (the state first, always a fresh one: every entry writes
its state in place); the capture auditor drives it across DEPTH_MATRIX,
and depth-independent entries ignore the argument.

JAX_NAMES maps every JAX entry name onto its port entry. The JAX
package's `create_transfers_chain_unrolled_jit` maps onto the chain
entry: the port's chain (`create_transfers_chain`) is already an
unrolled Python loop, one plain-tier run a prepare, so the JAX
package's scan form and its unrolled form have one counterpart.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

# The capture auditor's window-depth matrix, and the depth the census
# passes run at (the JAX registry's).
DEPTH_MATRIX = (1, 2, 8, 32)
REP_DEPTH = 4

CAPS = (1 << 10, 1 << 12)
N_PREPARE = 1024
N_SHARDS = 8
_STACK = 4

# JAX registry name -> port entry name.
JAX_NAMES = {
    "create_transfers_fast_jit": "create_transfers_fast",
    "create_transfers_fixpoint_jit": "create_transfers_fixpoint",
    "create_transfers_fixpoint_deep_jit": "create_transfers_fixpoint_deep",
    "create_transfers_balancing_jit": "create_transfers_balancing",
    "create_transfers_imported_jit": "create_transfers_imported",
    "create_transfers_imported_fixpoint_jit":
        "create_transfers_imported_fixpoint",
    "create_transfers_super_jit": "create_transfers_super",
    "create_transfers_super_deep_jit": "create_transfers_super_deep",
    "create_transfers_super_ring_jit": "create_transfers_super_ring",
    "create_transfers_super_deep_ring_jit":
        "create_transfers_super_deep_ring",
    "create_transfers_super_balancing_jit":
        "create_transfers_super_balancing",
    "create_transfers_chain_jit": "create_transfers_chain",
    "create_transfers_chain_ring_jit": "create_transfers_chain_ring",
    "create_transfers_chain_unrolled_jit": "create_transfers_chain",
    "sharded_plain_step": "sharded_plain_step",
    "sharded_fixpoint_step": "sharded_fixpoint_step",
    "partitioned_plain_step": "partitioned_plain_step",
    "partitioned_fixpoint_step": "partitioned_fixpoint_step",
    "partitioned_chain_step": "partitioned_chain_step",
}


@dataclasses.dataclass
class Entry:
    """One audited serving entry.

    route: flat | chain | sharded | partitioned | partitioned_chain.
    fn: the dispatch callable; fn(*make_args(depth)) runs it once.
    make_args: depth -> fresh inputs, the state first; the partitioned
      routes' also take `scale=`: the state at that many times the
      registry's capacities, its caps and the orphan floor that sizes a
      shard's transfer table (the sharding pass traces them at 2).
    depths: the window depths the capture auditor drives.
    mesh: the entry's `shard_utils.Mesh` (None: one device).
    n_state_leaves: tensors of one (per-shard) state.
    """

    name: str
    route: str
    fn: Callable
    make_args: Callable[[int], tuple]
    depths: tuple = (1,)
    mesh: object = None
    n_state_leaves: int = 0

    def trace(self, depth: int = REP_DEPTH):
        """The census (`core.Trace`) of one call at `depth`."""
        from .core import trace

        return trace(self.fn, *self.make_args(depth))


def _superbatch(device) -> tuple:
    from ..ops.ledger import events_to_device, stack_superbatch
    from ..trace.profiler import _chain_prepares

    ev_s, seg = stack_superbatch(*_chain_prepares(_STACK, N_PREPARE),
                                 N_PREPARE)
    return events_to_device(ev_s, device), events_to_device(seg, device)


def _n_leaves(state: dict) -> int:
    from ..ops.window_graph import _tensors

    return sum(1 for _ in _tensors(state))


def entries(device=None, include_mesh: bool = True) -> dict[str, Entry]:
    """name -> Entry for the whole audited dispatch surface, on `device`
    (None: the card). include_mesh=False leaves out the sharded and
    partitioned entries."""
    from ..ops import fast_kernels as FK
    from ..ops.device import resolve_device
    from ..ops.ledger import init_state
    from ..trace import profiler as PF

    dev = resolve_device(device)
    n_leaves = _n_leaves(init_state(*CAPS, device="meta"))
    out: dict[str, Entry] = {}

    def state():
        return PF._scratch_state(dev, CAPS)

    def flat_args(_d):
        return (state(), *PF._flat_operands(dev, N_PREPARE))

    def super_args(_d):
        return (state(), *_superbatch(dev))

    def chain_args(depth):
        return (state(), *PF._chain_operands(depth, dev, N_PREPARE))

    def add(name, route, fn, make_args, depths=(1,), mesh=None):
        out[name] = Entry(name=name, route=route, fn=fn,
                          make_args=make_args, depths=depths, mesh=mesh,
                          n_state_leaves=n_leaves)

    for name, fn in (
            ("create_transfers_fast", FK.create_transfers_fast),
            ("create_transfers_fixpoint", FK.create_transfers_fixpoint),
            ("create_transfers_fixpoint_deep",
             FK.create_transfers_fixpoint_deep),
            ("create_transfers_balancing", FK.create_transfers_balancing),
            ("create_transfers_imported", FK.create_transfers_imported),
            ("create_transfers_imported_fixpoint",
             FK.create_transfers_imported_fixpoint)):
        add(name, "flat", fn, flat_args)
    ring = functools.partial
    for name, fn in (
            ("create_transfers_super", FK.create_transfers_super),
            ("create_transfers_super_deep", FK.create_transfers_super_deep),
            ("create_transfers_super_ring",
             ring(FK.create_transfers_super, ring_reset=True)),
            ("create_transfers_super_deep_ring",
             ring(FK.create_transfers_super_deep, ring_reset=True)),
            ("create_transfers_super_balancing",
             FK.create_transfers_super_balancing)):
        add(name, "flat", fn, super_args)
    add("create_transfers_chain", "chain", FK.create_transfers_chain,
        chain_args, DEPTH_MATRIX)
    add("create_transfers_chain_ring", "chain",
        ring(FK.create_transfers_chain, ring_reset=True), chain_args,
        DEPTH_MATRIX)
    if include_mesh:
        out.update(mesh_entries(dev))
    return out


def mesh_entries(device=None) -> dict[str, Entry]:
    """name -> Entry for the sharded and partitioned entries alone, on
    `Mesh([device] * N_SHARDS)` (None: the card)."""
    from ..ops.device import resolve_device
    from ..ops.ledger import init_state
    from ..trace import profiler as PF

    dev = resolve_device(device)
    n_leaves = _n_leaves(init_state(*CAPS, device="meta"))
    out: dict[str, Entry] = {}

    def state():
        return PF._scratch_state(dev, CAPS)

    def add(name, route, fn, make_args, depths=(1,), mesh=None):
        out[name] = Entry(name=name, route=route, fn=fn,
                          make_args=make_args, depths=depths, mesh=mesh,
                          n_state_leaves=n_leaves)

    from ..ops.ledger import pad_transfer_events
    from ..ops.u64 import carrier
    from ..parallel.full_sharded import (make_sharded_create_transfers,
                                         shard_batch)
    from ..parallel.partitioned import (
        ORPHAN_FLOOR, make_partitioned_chain_create_transfers,
        make_partitioned_create_transfers, stack_partitioned_window)
    from ..parallel.shard_utils import Mesh, replicate

    mesh = Mesh([dev] * N_SHARDS)

    def sharded_args(_d):
        evs, tss = PF._chain_prepares(1, N_PREPARE)
        shards = shard_batch(mesh, pad_transfer_events(evs[0], N_PREPARE))
        return (replicate(mesh, state()), shards, tss[0], N_PREPARE)

    def part_state(scale):
        if scale == 1:
            return PF._partitioned_fixture(mesh, CAPS)[1]
        return PF._partitioned_state(mesh, tuple(scale * c for c in CAPS),
                                     scale * ORPHAN_FLOOR)

    def partitioned_args(_d, scale=1):
        return (part_state(scale), *PF._flat_operands(dev, N_PREPARE))

    def pchain_args(depth, scale=1):
        ev, ts, n = stack_partitioned_window(
            *PF._chain_prepares(depth, N_PREPARE), N_PREPARE)
        return (part_state(scale),
                {k: carrier(v, dev) for k, v in ev.items()},
                carrier(ts, dev), carrier(n, dev), None)

    for mode in ("plain", "fixpoint"):
        add(f"sharded_{mode}_step", "sharded",
            make_sharded_create_transfers(mesh, mode), sharded_args,
            mesh=mesh)
    for mode in ("plain", "fixpoint"):
        add(f"partitioned_{mode}_step", "partitioned",
            make_partitioned_create_transfers(mesh, mode), partitioned_args,
            mesh=mesh)
    add("partitioned_chain_step", "partitioned_chain",
        make_partitioned_chain_create_transfers(mesh, "plain"), pchain_args,
        DEPTH_MATRIX, mesh=mesh)
    return out
