"""Sharding-spec verifier: the partitioned layout, checked on the tensors.

The port's counterpart of the JAX package's `jaxhound/shardspec.py`. The
partitioned route exists so that ledger store rows never move: each
shard owns a hash range of the accounts, its state stays resident where
it lives, and only compact per-event bundles cross the mesh. The
collective lint (`core.state_gathers`) catches an exchange that moves
whole-state operands; this pass catches the quieter failure — a shard's
state that silently becomes the whole state (a replicated layout, a
state shared by every shard, a step that rebuilds the shards instead of
writing them) so every shard holds, copies and rewrites the whole ledger
again.

The JAX package reads shardings off a lowered program; the port's mesh
(`shard_utils.Mesh`) is a tuple of per-shard state dicts, so the pass
checks the tensors themselves, for every partitioned entry (routes
`partitioned` and `partitioned_chain`):

  replicated_state   each shard's state lies on its shard's device and
                     has the per-shard shapes (`init_state` at
                     `partitioned.shard_caps`), leaf for leaf
                     (n_state_leaves of them), not the whole ledger's;
  shared_storage     no two shards share a storage;
  moved_state        one step leaves every shard's leaves in place, the
                     counterpart of donation: the step returns the same
                     shard states, each tensor in the storage it had;
  state_sized_operand no operand of the step but the state, and no tensor
                     it passes through `shard_utils.all_gather` / `psum`,
                     reaches the whole-ledger size of the largest state
                     leaf (its per-shard size times the shards, as the
                     JAX verifier sizes a sharded argument by its global
                     array): a whole-state table shipped to every shard
                     defeats the layout even where the state is fine.
                     Nor does any collective's part from one shard grow
                     with the state: the step is traced again on the
                     same batch with a state at twice the registry's
                     capacities (its caps, and the orphan floor that
                     sizes a shard's transfer table: `verify_growth`),
                     and a part that grows moves state, not per-event
                     bundles. No size bound can
                     tell the two apart: at the registry's caps (2^10 /
                     2^12 over 8 shards) the exchange's account bundle
                     (4 x 1,024 rows, 819,200 B a part, O(batch)) is
                     larger than one shard's transfer table (786,624 B),
                     whose gather must RED.

Findings are strings prefixed with the rule; empty = the layout holds.
"""

from __future__ import annotations

import torch

from .core import trace as _trace


def _tensors(tree):
    from ..ops.window_graph import _tensors as walk

    return [t for t in walk(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def verify_layout(mesh, state, expect, n_state_leaves: int,
                  name: str = "entry") -> list[str]:
    """Layout findings for a partitioned `state` (one tree a local shard
    of `mesh`): each shard's tensors on its device, in the shapes of
    `expect` (one shard's tree of tensors or shape-bearing meta
    tensors), n_state_leaves of them, and no storage shared between
    shards."""
    fails: list[str] = []
    state = tuple(state)
    if len(state) != len(mesh.devices):
        return [f"{name}: replicated_state: {len(state)} shard states "
                f"for the {len(mesh.devices)} local shards of {mesh}"]
    want = [tuple(t.shape) for t in _tensors(expect)]
    owner: dict = {}
    for i, (sub, dev) in enumerate(zip(state, mesh.devices)):
        leaves = _tensors(sub)
        if len(leaves) != n_state_leaves:
            fails.append(
                f"{name}: replicated_state: shard {i} has {len(leaves)} "
                f"state leaves, not {n_state_leaves}")
        for j, t in enumerate(leaves):
            if t.device != dev:
                fails.append(
                    f"{name}: replicated_state: shard {i} leaf {j} lies "
                    f"on {t.device}, its shard's device is {dev}")
            if j < len(want) and tuple(t.shape) != want[j]:
                fails.append(
                    f"{name}: replicated_state: shard {i} leaf {j} has "
                    f"shape {list(t.shape)}, the per-shard shape is "
                    f"{list(want[j])} (a whole-state leaf on a shard)")
            key = (t.device, t.untyped_storage().data_ptr())
            if t.numel() and owner.setdefault(key, i) != i:
                fails.append(
                    f"{name}: shared_storage: shard {i} leaf {j} shares "
                    f"its storage with shard {owner[key]}")
    return fails


def verify_step(tr, mesh, name: str = "entry") -> list[str]:
    """Findings for one traced partitioned step (`core.Trace` of a call
    whose first argument is the shard states): the shards written in
    place and returned as they came, and no operand or collective tensor
    the whole-ledger size of the largest state leaf."""
    fails: list[str] = []
    state = tuple(tr.args[0])
    if tr.state_after != tr.state_before:
        moved = sum(1 for b, a in zip(tr.state_before, tr.state_after)
                    if b != a) + abs(len(tr.state_after)
                                     - len(tr.state_before))
        fails.append(f"{name}: moved_state: {moved} state leaves changed "
                     "shape, dtype or storage in one step")
    back = tr.result[0] if isinstance(tr.result, tuple) else None
    if back is not None and isinstance(back, (tuple, list)) and (
            len(back) != len(state)
            or any(b is not s for b, s in zip(back, state))):
        fails.append(f"{name}: moved_state: the step returned other shard "
                     "states than it was given")
    limit = mesh.size * max((_nbytes(t) for t in _tensors(state)),
                            default=0)
    for k, arg in enumerate(tr.args[1:], start=1):
        for t in _tensors(arg):
            if limit and _nbytes(t) >= limit:
                fails.append(
                    f"{name}: state_sized_operand: operand {k} holds a "
                    f"{_nbytes(t)} B tensor, the largest state leaf "
                    f"holds {limit} B over the mesh")
    for c in tr.collectives:
        if limit and c["leaf_bytes"] >= limit:
            fails.append(
                f"{name}: state_sized_operand: `{c['name']}` moves a "
                f"{c['leaf_bytes']} B tensor, the largest state leaf "
                f"holds {limit} B over the mesh")
    return fails


def verify_growth(tr, tr2, name: str = "entry") -> list[str]:
    """Findings for one partitioned step traced twice on the same batch,
    `tr` on a state at some capacities and `tr2` at twice them: every
    collective's part from one shard the same size in both (it grows
    with the batch, not with the state), and the same collectives."""
    names = [c["name"] for c in tr.collectives]
    if names != [c["name"] for c in tr2.collectives]:
        return [f"{name}: state_sized_operand: the step's collectives "
                f"{names} change with the caps: "
                f"{[c['name'] for c in tr2.collectives]}"]
    return [f"{name}: state_sized_operand: `{c['name']}` #{k} moves a "
            f"{c['part_bytes']} B part from one shard, {c2['part_bytes']} B "
            "at twice the capacities: it grows with the state"
            for k, (c, c2) in enumerate(zip(tr.collectives,
                                            tr2.collectives))
            if c2["part_bytes"] > c["part_bytes"]]


def shard_shapes(caps: tuple, n_shards: int) -> dict:
    """One shard's state at global `caps` on the meta device: the
    per-shard shapes."""
    from ..ops.ledger import init_state
    from ..parallel.partitioned import shard_caps

    a, t, o, e = shard_caps(caps[0], caps[1], None, n_shards)
    return init_state(a, t, orphan_cap=o, e_cap=e, device="meta")


def run(entries: dict, traces: dict | None = None) -> list[str]:
    """Run the verifier over the registry's partitioned entries (routes
    'partitioned' and 'partitioned_chain'), reading their census traces
    where `traces` has them and tracing them otherwise, and tracing each
    again with a state at twice the registry's capacities
    (`make_args(depth, scale=2)`)."""
    from .registry import CAPS, REP_DEPTH

    fails = []
    for name, entry in entries.items():
        if entry.route not in ("partitioned", "partitioned_chain"):
            continue
        tr = (traces or {}).get(name)
        if tr is None:
            tr = _trace(entry.fn, *entry.make_args(REP_DEPTH))
        fails.extend(verify_layout(entry.mesh, tr.args[0],
                                   shard_shapes(CAPS, entry.mesh.size),
                                   entry.n_state_leaves, name))
        fails.extend(verify_step(tr, entry.mesh, name))
        fails.extend(verify_growth(
            tr, _trace(entry.fn, *entry.make_args(REP_DEPTH, scale=2)),
            name))
    return fails
