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
every distinct device. `psum` sums the shards' contributions (the
partitioned route's exchange) and places the sum on every distinct
device.

A mesh may span processes (`parallel/multihost.py`): `process_count`
processes of k shards each, shard s held by process s // k. A process
holds and computes its own shards only (`local`, on `devices`), and
`all_gather` and `psum` reduce its own parts first and then call
`torch.distributed` (`all_gather`, `all_reduce`) on a gloo process
group. gloo is the only backend: a CUDA tensor goes through it as a copy
to host memory and back, inside the collective.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


def mix_id_np(k_hi, k_lo):
    """Host-side `mix_id` over numpy uint64 limb arrays (the hash's u64
    values out). Bit-identical: numpy's uint64 multiplies wrap."""
    k_hi = np.asarray(k_hi, dtype=np.uint64)
    k_lo = np.asarray(k_lo, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = (k_lo ^ (k_hi * np.uint64(_C1))) * np.uint64(_C2)
        h = (h ^ (h >> np.uint64(31))) * np.uint64(_C3)
    return h ^ (h >> np.uint64(29))


def in_range_np(h, lo: int, hi: int):
    """lo <= h <= hi over numpy uint64 hashes (unsigned, as uint64
    compares)."""
    return (h >= np.uint64(lo)) & (h <= np.uint64(hi))


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


BACKEND = "gloo"

# None but while a census counts a call (trace/profiler.py `_count`):
# then every `all_gather` and `psum` reports its parts to it first (a
# dispatch mode sees a collective only as the copies and sums it is made
# of).
COST = None


class Mesh:
    """An ordered tuple of devices along one axis, one a shard; a device
    may appear more than once (logical shards on one device).

    On a multi-process mesh `devices` are this process's shards' devices
    (k of them) and the mesh has `process_count` x k shards; `local` is
    the global indexes of this process's shards (all of them in one
    process). The collectives run on the default `torch.distributed`
    process group, which must be gloo's."""

    def __init__(self, devices, *, process_count: int = 1,
                 process_index: int = 0, backend: str = BACKEND):
        if backend != BACKEND:
            raise ValueError(f"a mesh's collectives run on {BACKEND} only "
                             f"(asked for {backend!r})")
        self.devices = tuple(_normal(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of {process_count}")
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        k = len(self.devices)
        self.local = tuple(range(self.process_index * k,
                                 (self.process_index + 1) * k))
        # Each distinct device once, in order of first appearance: where
        # replicated state and the gathered bundles live.
        self.distinct = tuple(dict.fromkeys(self.devices))

    @property
    def size(self) -> int:
        return len(self.devices) * self.process_count

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    def __repr__(self) -> str:
        extra = (f", process {self.process_index} of {self.process_count}"
                 if self.process_count > 1 else "")
        return f"Mesh({[str(d) for d in self.devices]}{extra})"


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


def _local_parts(mesh: Mesh, parts) -> list:
    parts = list(parts)
    if len(parts) != len(mesh.devices):
        raise ValueError(f"{len(parts)} parts for the {len(mesh.devices)} "
                         f"local shards of a mesh of {mesh.size}")
    return parts


def _process_group():
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a multi-process mesh needs torch.distributed "
                           "initialized (parallel/multihost.init_multihost)")
    if dist.get_backend() != BACKEND:
        raise RuntimeError(f"a multi-process mesh runs on {BACKEND}, not "
                           f"{dist.get_backend()}")
    return dist


def all_gather(mesh: Mesh, parts) -> tuple:
    """The mesh all-gather: `parts` holds one dict of tensors a local
    shard, in mesh order, each on its shard's device; every key is
    concatenated along dim 0 in mesh order and placed on each distinct
    device. Returns one dict a distinct device, in `mesh.distinct` order.
    Across processes the local concatenation goes through
    `torch.distributed.all_gather` (every process's parts of one shape),
    in host memory."""
    parts = _local_parts(mesh, parts)
    if COST is not None:
        COST.collective("all_gather", parts)
    d0 = mesh.distinct[0]
    cat = {k: torch.cat([p[k].to(d0) for p in parts]) for k in parts[0]}
    if mesh.process_count > 1:
        dist = _process_group()
        for k, v in cat.items():
            host = v.cpu()
            bufs = [torch.empty_like(host) for _ in range(mesh.process_count)]
            dist.all_gather(bufs, host)
            cat[k] = torch.cat(bufs).to(d0)
    return tuple({k: v.to(d) for k, v in cat.items()}
                 for d in mesh.distinct)


def psum(mesh: Mesh, parts) -> tuple:
    """The mesh sum: `parts` holds one tensor a shard, in mesh order, each
    on its shard's device, all of one shape; they are summed in mesh
    order and the sum is placed on each distinct device. Returns one
    tensor a distinct device, in `mesh.distinct` order.

    The partitioned route's exchange (`parallel/partitioned.py`) sums
    int64 tensors carrying u64 lanes (`ops/u64.py`): the sum wraps
    around as u64 does, so it equals the JAX package's `psum` over
    uint64 bit for bit. Booleans are summed as int64. On a multi-process
    mesh `parts` are this process's shards' and their sum goes through
    `torch.distributed.all_reduce` in host memory: gloo's int64 sum wraps
    as u64 does."""
    parts = _local_parts(mesh, parts)
    if COST is not None:
        COST.collective("psum", parts)
    parts = [p.to(torch.int64) if p.dtype == torch.bool else p
             for p in parts]
    if mesh.process_count > 1:
        d0 = mesh.distinct[0]
        total = parts[0].to(d0)
        for p in parts[1:]:
            total = total + p.to(d0)
        host = total.cpu()
        _process_group().all_reduce(host)
        return tuple(host.to(d) for d in mesh.distinct)
    out = []
    for d in mesh.distinct:
        total = parts[0].to(d)
        for p in parts[1:]:
            total = total + p.to(d)
        out.append(total)
    return tuple(out)


def psum_host(mesh: Mesh, values: list) -> list:
    """Wrap-sum a list of u64 Python ints across the processes of `mesh`
    (the same list on every process); in one process the list itself."""
    if mesh.process_count == 1:
        return list(values)
    from ..ops.u64 import u64

    t = torch.tensor([s64(v) for v in values], dtype=torch.int64)
    _process_group().all_reduce(t)
    return [u64(v) for v in t.tolist()]
