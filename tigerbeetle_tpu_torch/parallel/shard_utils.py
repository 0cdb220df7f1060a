"""Shared plumbing for the sharded modules: the ownership hash and its
migration overlay, and the port's in-process mesh.

Ownership: `shard_of_id()` says which mesh shard owns a 128-bit object
id. Device code, host packers and digest packs all route through this
one definition, so they can never disagree about ownership. Elastic
shards extend the base map with an overlay: a generation-tagged table
of hash ranges mid-migration. An entry `(lo, hi, src, dst, mode)` says
ids whose 64-bit ownership hash falls in [lo, hi] (inclusive) and whose
base owner is `src` are being moved to `dst`. `mode` is
OVERLAY_DOUBLE_WRITE (src answers reads; both apply writes),
OVERLAY_MIGRATED (dst owns reads and writes) or OVERLAY_RETURNING (the
backward copy of a merge home: dst reads, both write). Host
(`owner_read_int`) and device (`owner_read` / `writes_here`) consult it
bit-identically: both derive the same `mix_id` hash and walk the same
entry tuple. The device forms take int64 tensors carrying u64 lanes, so
the hash's shifts are logical (`u64.srl`) and its multiplies wrap, as
in u64; ids with the top bit set hash as on the host.

The mesh: the JAX package drives every device from one process through
shard_map. The port's counterpart is in-process too: a `Mesh` is an
ordered tuple of torch.devices along one axis ("batch"), one a shard.
A mesh may name one device more than once — 8 logical shards on one
CPU, or on one card — the counterpart of the JAX tests'
`--xla_force_host_platform_device_count=8`. Replicated state is held
once for each distinct device (`replicate`), and `all_gather`
concatenates the shards' bundles in mesh order and places the result on
every distinct device: the one place a multi-host mesh would put a
`torch.distributed` all-gather behind the same call. `psum` is the
second such place: the partitioned route's exchange sums the shards'
contributions and places the sum on every distinct device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.u64 import s64, srl

_C1 = 0x9E3779B97F4A7C15
_C2 = 0xBF58476D1CE4E5B9
_C3 = 0x94D049BB133111EB
_M64 = (1 << 64) - 1

AXIS = "batch"


# ------------------------------------------------------------ ownership

def mix_id(k_hi, k_lo):
    """The full 64-bit ownership hash of a 128-bit id: int64 tensors
    carrying the u64 limbs in, the hash's u64 bits as int64 out.
    `shard_of_id` is its low bits; overlay ranges are defined over the
    whole hash."""
    h = (k_lo ^ (k_hi * s64(_C1))) * s64(_C2)
    h = (h ^ srl(h, 31)) * s64(_C3)
    return h ^ srl(h, 29)


def mix_int(id128: int) -> int:
    """Host-side `mix_id` over a python 128-bit int. Bit-identical."""
    k_hi = (id128 >> 64) & _M64
    k_lo = id128 & _M64
    h = ((k_lo ^ (k_hi * _C1 & _M64)) * _C2) & _M64
    h = ((h ^ (h >> 31)) * _C3) & _M64
    return h ^ (h >> 29)


def shard_of_id(k_hi, k_lo, n_shards: int):
    """Owning shard (int32) of each 128-bit id: the mix masked to
    `n_shards` (a power of two, as mesh sizes are)."""
    assert n_shards & (n_shards - 1) == 0, n_shards
    return (mix_id(k_hi, k_lo) & (n_shards - 1)).to(torch.int32)


def shard_of_int(id128: int, n_shards: int) -> int:
    """Host-side shard_of_id over a python 128-bit int. Bit-identical."""
    assert n_shards & (n_shards - 1) == 0, n_shards
    return mix_int(id128) & (n_shards - 1)


# ------------------------------------------------------------- overlay
# Membership of an id in an entry is always tested against the BASE map
# (`base_owner == src`), so an entry's meaning never depends on others.
OVERLAY_DOUBLE_WRITE = 1
OVERLAY_MIGRATED = 2
OVERLAY_RETURNING = 3


def _validate_overlay(entries: tuple, n_shards: int) -> None:
    spans: list = []
    for e in entries:
        lo, hi, src, dst, mode = e
        assert 0 <= lo <= hi <= _M64, e
        assert 0 <= src < n_shards and 0 <= dst < n_shards, e
        assert src != dst, e
        assert mode in (OVERLAY_DOUBLE_WRITE, OVERLAY_MIGRATED,
                        OVERLAY_RETURNING), e
        for (plo, phi, psrc) in spans:
            if psrc == src and not (hi < plo or lo > phi):
                raise AssertionError(
                    f"overlapping overlay ranges for shard {src}")
        spans.append((lo, hi, src))


def _in_range(h, lo: int, hi: int):
    """lo <= h <= hi in u64 order, on the hash's int64 carrier (bit 63
    flipped, the signed order is the unsigned one)."""
    flip = -(1 << 63)
    hf = h ^ flip
    return (hf >= s64(lo) ^ flip) & (hf <= s64(hi) ^ flip)


def owner_read(k_hi, k_lo, n_shards: int, overlay: tuple = ()):
    """READ owner of each id under an (optionally empty) overlay: the
    shard whose copy is authoritative now. With an empty overlay this is
    `shard_of_id`."""
    base = shard_of_id(k_hi, k_lo, n_shards)
    if not overlay:
        return base
    h = mix_id(k_hi, k_lo)
    owner = base
    for (lo, hi, src, dst, mode) in overlay:
        if mode == OVERLAY_DOUBLE_WRITE:
            continue  # copy-catchup ranges still read from src == base
        inr = _in_range(h, lo, hi) & (base == src)
        owner = torch.where(inr, dst, owner)
    return owner


def writes_here(k_hi, k_lo, n_shards: int, me, overlay: tuple = ()):
    """Boolean per id: does shard `me` apply writes for it. Equals
    `owner_read(...) == me` except during copy-catchup, where the
    non-reading owner writes too (DOUBLE_WRITE: dst; RETURNING: src)."""
    w = owner_read(k_hi, k_lo, n_shards, overlay) == me
    if not overlay:
        return w
    h = mix_id(k_hi, k_lo)
    base = shard_of_id(k_hi, k_lo, n_shards)
    for (lo, hi, src, dst, mode) in overlay:
        if mode == OVERLAY_MIGRATED:
            continue
        other = dst if mode == OVERLAY_DOUBLE_WRITE else src
        inr = _in_range(h, lo, hi) & (base == src)
        w = w | (inr & (torch.as_tensor(me) == other))
    return w


def owner_read_int(id128: int, n_shards: int, overlay: tuple = ()) -> int:
    """Host-side `owner_read` over a python int. Bit-identical."""
    h = mix_int(id128)
    base = h & (n_shards - 1)
    for (lo, hi, src, dst, mode) in overlay:
        if (mode != OVERLAY_DOUBLE_WRITE and lo <= h <= hi
                and base == src):
            return dst
    return base


def write_owners_int(id128: int, n_shards: int,
                     overlay: tuple = ()) -> tuple:
    """Host-side write-owner set of an id (1 shard normally, 2 while
    its range is in copy-catchup)."""
    h = mix_int(id128)
    base = h & (n_shards - 1)
    owners = [owner_read_int(id128, n_shards, overlay)]
    for (lo, hi, src, dst, mode) in overlay:
        if mode == OVERLAY_MIGRATED or not (lo <= h <= hi
                                            and base == src):
            continue
        other = dst if mode == OVERLAY_DOUBLE_WRITE else src
        if other not in owners:
            owners.append(other)
    return tuple(sorted(owners))


@dataclass(frozen=True)
class OwnershipTable:
    """The host-side ownership authority: base map (the mix over
    `n_shards`) plus the generation-tagged overlay. Ownership changes only
    by swapping in a new table with a bumped generation."""
    n_shards: int
    generation: int = 0
    entries: tuple = ()

    def __post_init__(self):
        assert self.n_shards & (self.n_shards - 1) == 0, self.n_shards
        _validate_overlay(self.entries, self.n_shards)

    @property
    def active(self) -> bool:
        return bool(self.entries)

    def owner_read_int(self, id128: int) -> int:
        return owner_read_int(id128, self.n_shards, self.entries)

    def write_owners_int(self, id128: int) -> tuple:
        return write_owners_int(id128, self.n_shards, self.entries)

    def with_entry(self, lo: int, hi: int, src: int, dst: int,
                   mode: int) -> "OwnershipTable":
        return OwnershipTable(
            self.n_shards, self.generation + 1,
            self.entries + ((lo, hi, src, dst, mode),))

    def transition(self, entry: tuple, mode: int) -> "OwnershipTable":
        """The same range, next stage (e.g. DOUBLE_WRITE -> MIGRATED at a
        forward flip, MIGRATED -> RETURNING when a merge-home copy
        begins)."""
        lo, hi, src, dst, _m = entry
        out = tuple((lo, hi, src, dst, mode) if e[:4] == (lo, hi, src, dst)
                    else e for e in self.entries)
        table = OwnershipTable(self.n_shards, self.generation + 1, out)
        assert any(e[:4] == (lo, hi, src, dst) for e in out), entry
        return table

    def without_entry(self, entry: tuple) -> "OwnershipTable":
        """Drop a range from the overlay (an abort's revert, or the
        completing flip of a RETURNING merge): ids in it route by the
        base map again."""
        out = tuple(e for e in self.entries if e[:4] != entry[:4])
        assert out != self.entries, (entry, self.entries)
        return OwnershipTable(self.n_shards, self.generation + 1, out)


# ----------------------------------------------------------------- mesh

def _normal(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An ordered tuple of devices along one axis, one a shard; a device
    may appear more than once (logical shards on one device)."""

    def __init__(self, devices):
        self.devices = tuple(_normal(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        # Each distinct device once, in order of first appearance: where
        # replicated state and the gathered bundles live.
        self.distinct = tuple(dict.fromkeys(self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def default_mesh(device=None) -> Mesh:
    """Every CUDA device, one shard each (None: the card); on "cpu", 8
    logical shards on the CPU, the JAX tests' mesh."""
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run on the CPU")
        return Mesh([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
    return Mesh([torch.device(device)] * 8)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def replicate(mesh: Mesh, state: dict) -> tuple:
    """Replicated ledger state: one state dict a distinct mesh device, in
    `mesh.distinct` order. The first is `state` itself when it lives on
    that device already; every other is a copy."""
    out = []
    for d in mesh.distinct:
        same = state["accounts"]["u64"].device == d
        out.append(state if same and not out else _to(state, d))
    return tuple(out)


def all_gather(mesh: Mesh, parts) -> tuple:
    """The mesh all-gather: `parts` holds one dict of tensors a shard, in
    mesh order, each on its shard's device; every key is concatenated
    along dim 0 in mesh order and placed on each distinct device. Returns
    one dict a distinct device, in `mesh.distinct` order."""
    parts = list(parts)
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size}")
    out = []
    for d in mesh.distinct:
        out.append({k: torch.cat([p[k].to(d) for p in parts])
                    for k in parts[0]})
    return tuple(out)


def psum(mesh: Mesh, parts) -> tuple:
    """The mesh sum: `parts` holds one tensor a shard, in mesh order, each
    on its shard's device, all of one shape; they are summed in mesh
    order and the sum is placed on each distinct device. Returns one
    tensor a distinct device, in `mesh.distinct` order.

    The partitioned route's exchange (`parallel/partitioned.py`) sums
    int64 tensors carrying u64 lanes (`ops/u64.py`): the sum wraps
    around as u64 does, so it equals the JAX package's `psum` over
    uint64 bit for bit. Booleans are summed as int64. This is the second
    of the two places (beside `all_gather`) where a multi-host mesh would
    put a `torch.distributed` collective behind the same call."""
    parts = list(parts)
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size}")
    parts = [p.to(torch.int64) if p.dtype == torch.bool else p
             for p in parts]
    out = []
    for d in mesh.distinct:
        total = parts[0].to(d)
        for p in parts[1:]:
            total = total + p.to(d)
        out.append(total)
    return tuple(out)
