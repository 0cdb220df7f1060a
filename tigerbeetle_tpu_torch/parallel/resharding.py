"""Live resharding: moving a hash range between shards under traffic.

A port of the JAX package's `parallel/resharding.py`. The partitioned
layout (`parallel/partitioned.py`) fixes each object's shard by a pure
hash, which balances uniform traffic and has no answer when one hash
range runs hot. This module moves an account-hash range between shards
while windows keep committing, in five stages, each irreversible step
gated by a digest witness:

  1. SNAPSHOT: quiesced (the caller's contract: no window in flight),
     fetch the source shard's stores to the host, filter the range's rows
     with numpy, and check the filtered pack's position-independent range
     digest (`ops/state_epoch.partitioned_range_digest`) against the
     device's, and against the oracle's when the driver holds one. The
     range is frozen from here: a window touching it is a conflict until
     double-write starts.
  2. COPY: the snapshot's account, transfer and ring rows go to the target
     in bounded chunks, appended at the target's counts (`_install_chunk`;
     the room is checked on the host first). Staged rows are not in the
     target's hash tables yet, so no lookup sees a half-copied range. The
     source serves all other traffic; a window that conflicts with the
     frozen range drains the remaining chunks first (a bounded stall), as
     deferring it would reorder history against the oracle.
  3. DOUBLE-WRITE: after the last chunk one finalize (`_finalize_shard`)
     restores the target's canonical row order (by timestamp, the order
     the epoch digest pins), remaps the table values through the
     permutation (a key's bucket depends only on the key) and inserts the
     staged keys and the range's orphan markers. Then the overlay entry
     (`shard_utils.OVERLAY_DOUBLE_WRITE`) goes live: reads come from the
     source, writes land on both copies (the owner-masked write-back under
     `writes_here`) for at least `min_double_write_windows` windows.
  4. FLIP: at a window boundary, ownership moves to the target only if the
     source's and the target's range digests (content and row counts) are
     equal, and the oracle's when held. A mismatch aborts: the entry is
     reverted, the staged copy evicted and the flight recorder dumps a
     FLIGHT_*_reshard_* artifact. The flip is one host-side swap of the
     ownership table; the router keys its steps (and the ledger its chain
     graphs) by the overlay entries, so the next window takes the new body.
  5. RETIRE: right after a clean flip the stale copy is evicted
     (`_evict_range`: kept rows compacted in order, the tail zeroed, the
     range's table keys dropped with each bucket re-compacted, surviving
     values remapped). The entry stays as OVERLAY_MIGRATED; `merge_back`
     runs the same protocol in reverse (OVERLAY_RETURNING, and its flip
     drops the entry).

Crash safety: every stage before the flip is invisible to ownership. A
crash recovers by reverting the entry and rebuilding from the oracle
(`PartitionedRouter.resync`), the `reshard_abort` recovery cause. A crash
after the flip keeps the MIGRATED entry, and the rebuild places the range
on the target.

The port's state is the tuple of per-shard dicts (`partitioned.py`).
Each device kernel works on one shard's dict on that shard's device and
writes its results in place (`copy_` into the existing tensors), so the
state's storage never moves: the ledger's captured chain graphs stay
valid across a migration. The permuted rows are computed into scratch
tensors first and copied back after every read. Every row gather goes
through the row-gather kernel (`ops/row_gather.py`), the account rows and
balances at one permutation in one launch; the key probes of
`_insert_missing` and `_drop_range_keys` stay the plain
`ops/hash_table` code, as in the JAX package.

Hashes are compared in u64 order everywhere (`shard_utils._in_range` on
the device, numpy uint64 on the host): a range with hi >= 2^63 is
ordinary.

Not in scope, by design (as in the JAX package): ring rows carry no ids,
so they are copied only from an oracle's account events (with dump row
pointers), and a retired source's ring rows stay as scratch; the
whole-state epoch digest is not comparable mid-copy (the supervisor
drains a migration first); stored dr_row / cr_row words go stale when
finalize re-sorts the accounts, and every reader re-derives them.

`HotRangeDetector` turns per-shard load into split proposals (propose
only) or the `unsplittable` verdict for a single hot account.

Resharding runs on a mesh of one process.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.ev_layout import AC_NCOLS, AC_U64_IDX, EV_NCOLS, XF_NCOLS, \
    XF_U64_IDX
from ..ops.hash_table import (ORPHAN_VAL, SLOTS, _low_i32, ht_lookup,
                              ht_plan, ht_write)
from ..ops.row_gather import row_gather_multi
from ..ops.state_epoch import (oracle_range_digest, pack_range_digest,
                               partitioned_range_digest)
from ..ops.u64 import U64_MAX, _flip, carrier
from ..trace import Event, NullTracer
from .shard_utils import (OVERLAY_DOUBLE_WRITE, OVERLAY_MIGRATED,
                          OVERLAY_RETURNING, _in_range, in_range_np, mix_id,
                          mix_id_np, mix_int)

__all__ = ["ReshardPlan", "ReshardController", "HotRangeDetector",
           "MigrationAborted"]

_U64_MASK = (1 << 64) - 1
_AC_TS = AC_U64_IDX["ts"]
_XF_TS = XF_U64_IDX["ts"]


class MigrationAborted(RuntimeError):
    """A migration aborted before its flip (digest mismatch, capacity,
    table overflow, recovery). Ownership is reverted and the staged copy
    evicted when this raises; the range serves from its owner before the
    migration, unchanged."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(reason + (f": {detail}" if detail else ""))
        self.reason = reason
        self.detail = detail


@dataclass(frozen=True)
class ReshardPlan:
    """One range move: ids whose ownership hash (shard_utils.mix_id) is in
    [lo, hi] (inclusive, u64 order) and whose base owner is `src` move to
    `dst`. `kind` is 'migrate' or 'split' (forward; a split is a migrate
    the hot-range detector proposed) or 'merge_back' (the reverse of an
    earlier migration, which needs its OVERLAY_MIGRATED entry)."""

    lo: int
    hi: int
    src: int
    dst: int
    kind: str = "migrate"

    def __post_init__(self):
        assert 0 <= self.lo <= self.hi <= _U64_MASK, (self.lo, self.hi)
        assert self.src != self.dst, self
        assert self.kind in ("migrate", "split", "merge_back"), self.kind

    def in_range(self, id128: int, n_shards: int) -> bool:
        h = mix_int(id128)
        return (self.lo <= h <= self.hi
                and (h & (n_shards - 1)) == self.src)


# ------------------------------------------------------ device kernels
# Control-plane kernels over one shard's state dict, run eagerly between
# windows; they add nothing to a window's body.

def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _install_chunk(sub: dict, a_u64, a_bal, a_n: int, x_u64, x_n: int,
                   e_u64, e_n: int) -> dict:
    """Append one copy chunk at the receiving shard's counts, in place.
    Chunks are zero-padded to a fixed row count; the pad lanes write zeros
    to the dump row (every duplicate lane the same value; the dump row is
    scratch). Counts grow by the valid rows only. The room is the caller's
    check: an index past the dump row would land on live rows."""

    def append(store, keys, rows_list, n):
        cap = store["u64"].shape[0]
        iota = _iota(rows_list[0].shape[0], store["u64"].device)
        idx = torch.where(iota < n, store["count"].to(torch.int64) + iota,
                          cap - 1)
        for k, rows in zip(keys, rows_list):
            store[k][idx] = rows
        store["count"].copy_(store["count"] + n)

    append(sub["accounts"], ("u64", "bal"), (a_u64, a_bal), a_n)
    append(sub["transfers"], ("u64",), (x_u64,), x_n)
    append(sub["events"], ("u64",), (e_u64,), e_n)
    return sub


def _remap_table_vals(packed, newpos):
    """A packed table with every live row-index value remapped through a
    row permutation (`newpos`: old row -> new row): a key's bucket depends
    only on the key, so values move without touching the structure.
    Orphan markers (< 0) and empty slots pass through. Returns a new
    matrix."""
    kh = packed[:, :SLOTS]
    kl = packed[:, SLOTS:2 * SLOTS]
    v = _low_i32(packed[:, 2 * SLOTS:])
    live = ((kh != 0) | (kl != 0)) & (v >= 0)
    cap = newpos.shape[0]
    v2 = torch.where(live, newpos[v.clamp(0, cap - 1)].to(torch.int64), v)
    return torch.cat([kh, kl, v2], dim=1)


def _sort_perm(u64, count, ts_col: int):
    """The canonical order of one store's live rows, by timestamp (commit
    timestamps are unique a store): (perm: new row -> old row, newpos: old
    row -> new row). Dead rows key as u64::MAX and sort last by index: one
    stable sort on the bit-63-flipped key is the JAX package's
    lexsort((iota, key))."""
    cap = u64.shape[0]
    iota = _iota(cap, u64.device)
    key = torch.where(iota < count, u64[:, ts_col], U64_MAX)
    perm = torch.argsort(_flip(key), stable=True)
    newpos = torch.empty_like(perm)
    newpos[perm] = iota
    return perm, newpos


def _permute_rows(tables, perm, count) -> list:
    """The tables' rows at `perm` (one row-gather launch for all of them),
    the rows at and after `count` zeroed: scratch tensors."""
    iota = _iota(perm.shape[0], perm.device)
    live = (iota < count)[:, None]
    return [torch.where(live, t, 0)
            for t in row_gather_multi(tables, perm)]


def _sort_store(u64, count, ts_col: int):
    """One store's live rows re-sorted by timestamp: (the sorted matrix
    with its tail zeroed, perm, newpos). A scratch matrix."""
    perm, newpos = _sort_perm(u64, count, ts_col)
    (sorted_u64,) = _permute_rows((u64,), perm, count)
    return sorted_u64, perm, newpos


def _insert_missing(table: dict, u64, count):
    """Insert every live row id absent from `table` with its row index as
    value (the staged rows' pass of finalize), in place. Returns (table,
    ok)."""
    cap = u64.shape[0]
    k_hi, k_lo = u64[:, 0], u64[:, 1]
    iota = _iota(cap, u64.device)
    valid = iota < count
    found, _ = ht_lookup(table, k_hi, k_lo)
    ins = valid & ~found
    pos, ok = ht_plan(table, k_hi, k_lo, ins)
    table = ht_write(table, pos, k_hi, k_lo, iota.to(torch.int32), ins & ok)
    return table, ok


def _finalize_shard(sub: dict, o_hi, o_lo, o_n: int):
    """Finalize the receiving shard after its copy, in place: the
    canonical row order restored (the appended chunks interleave by
    timestamp with the shard's own rows), the tables' values remapped
    through the permutation, the staged keys inserted at their new rows
    and the range's orphan markers carried over. Returns ok, a bool
    tensor: False means a table overflowed and the caller must abort
    (nothing else checks)."""
    acc, xfr = sub["accounts"], sub["transfers"]
    a_cnt = acc["count"]
    a_perm, a_newpos = _sort_perm(acc["u64"], a_cnt, _AC_TS)
    au_s, ab_s = _permute_rows((acc["u64"], acc["bal"]), a_perm, a_cnt)
    aht = {"packed": _remap_table_vals(sub["acct_ht"]["packed"], a_newpos)}
    aht, ok_a = _insert_missing(aht, au_s, a_cnt)

    x_cnt = xfr["count"]
    xu_s, _x_perm, x_newpos = _sort_store(xfr["u64"], x_cnt, _XF_TS)
    xht = {"packed": _remap_table_vals(sub["xfer_ht"]["packed"], x_newpos)}
    xht, ok_x = _insert_missing(xht, xu_s, x_cnt)
    # The range's orphan markers (transiently failed ids with no row):
    # unique, absent from the target, valued ORPHAN_VAL.
    o_ins = _iota(o_hi.shape[0], o_hi.device) < o_n
    o_pos, ok_o = ht_plan(xht, o_hi, o_lo, o_ins)
    ht_write(xht, o_pos, o_hi, o_lo,
             torch.full(o_hi.shape, ORPHAN_VAL, dtype=torch.int32,
                        device=o_hi.device), o_ins & ok_o)
    # Writes, after every read above.
    acc["u64"].copy_(au_s)
    acc["bal"].copy_(ab_s)
    xfr["u64"].copy_(xu_s)
    sub["acct_ht"]["packed"].copy_(aht["packed"])
    sub["xfer_ht"]["packed"].copy_(xht["packed"])
    return ok_a & ok_x & ok_o


def _range_member(h, lo: int, hi: int, base_shard: int, n_shards: int):
    return _in_range(h, lo, hi) & ((h & (n_shards - 1)) == base_shard)


def _drop_range_keys(packed, lo: int, hi: int, base_shard: int,
                     n_shards: int):
    """A packed table with every slot zeroed whose key's ownership hash is
    in [lo, hi] with base owner `base_shard` (orphan markers too: they
    have keys and no rows), each bucket's slots re-compacted to a leading
    non-empty prefix (the planner's occupancy invariant). Returns a new
    matrix."""
    kh = packed[:, :SLOTS]
    kl = packed[:, SLOTS:2 * SLOTS]
    v = packed[:, 2 * SLOTS:]
    drop = (((kh != 0) | (kl != 0))
            & _range_member(mix_id(kh, kl), lo, hi, base_shard, n_shards))
    kh = torch.where(drop, 0, kh)
    kl = torch.where(drop, 0, kl)
    v = torch.where(drop, 0, v)
    empty = (kh == 0) & (kl == 0)
    slot = _iota(SLOTS, packed.device)[None, :]
    # Unique keys a bucket (empty flag major, slot minor): any sort gives
    # the same order.
    order = torch.argsort(empty.to(torch.int64) * SLOTS + slot, dim=1)
    return torch.cat([torch.take_along_dim(x, order, dim=1)
                      for x in (kh, kl, v)], dim=1)


def _evict_perm(u64, count, lo: int, hi: int, n_shards: int,
                base_shard: int):
    """The kept rows of one store first, in their (canonical) order:
    (perm, newpos, the kept count)."""
    cap = u64.shape[0]
    iota = _iota(cap, u64.device)
    inr = _range_member(mix_id(u64[:, 0], u64[:, 1]), lo, hi, base_shard,
                        n_shards)
    keep = (iota < count) & ~inr
    perm = torch.argsort(torch.where(keep, iota, cap + iota))
    newpos = torch.empty_like(perm)
    newpos[perm] = iota
    return perm, newpos, keep.sum().to(torch.int32)


def _evict_range(sub: dict, lo: int, hi: int, n_shards: int,
                 base_shard: int) -> dict:
    """Evict a hash range from one shard's stores and tables, in place:
    the retire (the migration's source) and the abort (the receiver:
    staged rows carry the same base owner, so one kernel serves both).
    Kept rows compact in order, dropped and tail rows zero, the range's
    table keys drop with each bucket re-compacted, surviving values remap.
    The ring is untouched (no id columns: scratch)."""
    acc, xfr = sub["accounts"], sub["transfers"]
    a_perm, a_newpos, a_cnt2 = _evict_perm(acc["u64"], acc["count"], lo, hi,
                                           n_shards, base_shard)
    au, ab = _permute_rows((acc["u64"], acc["bal"]), a_perm, a_cnt2)
    x_perm, x_newpos, x_cnt2 = _evict_perm(xfr["u64"], xfr["count"], lo, hi,
                                           n_shards, base_shard)
    (xu,) = _permute_rows((xfr["u64"],), x_perm, x_cnt2)
    aht = _remap_table_vals(_drop_range_keys(
        sub["acct_ht"]["packed"], lo, hi, base_shard, n_shards), a_newpos)
    xht = _remap_table_vals(_drop_range_keys(
        sub["xfer_ht"]["packed"], lo, hi, base_shard, n_shards), x_newpos)
    # Writes, after every read above.
    acc["u64"].copy_(au)
    acc["bal"].copy_(ab)
    acc["count"].copy_(a_cnt2)
    xfr["u64"].copy_(xu)
    xfr["count"].copy_(x_cnt2)
    sub["acct_ht"]["packed"].copy_(aht)
    sub["xfer_ht"]["packed"].copy_(xht)
    return sub


def _host(t) -> np.ndarray:
    """A tensor carrying u64 lanes -> a numpy uint64 array on the host."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint64) if a.dtype == np.int64 else a


# --------------------------------------------------------- controller

def _digest_eq(a: dict, b: dict) -> bool:
    return all(int(a[k]) == int(b[k]) for k in a)


class ReshardController:
    """The five-stage migration over a PartitionedRouter.

    The driver's contract: construct, `begin(state, plan)` while
    quiesced, then call `on_window(state, batches)` once a commit window
    before dispatching it. The controller advances one copy chunk a window
    (drains on a range conflict), starts double-write when the copy is
    complete, and flips and retires, quiesced at that same boundary, once
    `min_double_write_windows` windows ran under double-write. Each method
    that touches the device takes the state tuple and returns it; the
    kernels update it in place, so it is the same tuple.

    `batches` may be Transfer-object batches or SoA ev dicts: the conflict
    check hashes ids either way, as the device does (shard_utils.mix_int /
    mix_id_np).

    Aborts raise MigrationAborted after restoring the world before the
    migration: the overlay reverted, the staged copy evicted, a flight
    artifact (FLIGHT_*_reshard_*). `on_recovery()` is the crash path: no
    device work (the resync rebuild replaces the state), the ownership
    revert and the `reshard_abort` bookkeeping."""

    STAGES = ("snapshot", "copy", "double_write", "flip", "retire")

    def __init__(self, router, *, tracer=None, chunk_rows: int = 256,
                 min_double_write_windows: int = 2,
                 capacity_margin: int = 8):
        self.router = router
        self.tracer = tracer if tracer is not None \
            else getattr(router, "tracer", None) or NullTracer()
        self.chunk_rows = int(chunk_rows)
        self.min_double_write_windows = int(min_double_write_windows)
        self.capacity_margin = int(capacity_margin)
        self.plan: ReshardPlan | None = None
        self.stage = "idle"
        self.rows_copied = 0
        self.dw_windows = 0
        self.migrations: list = []   # completed migrations' records
        self.aborts: list = []       # aborts' records
        # Test hook: when armed, the next transfer chunk's rows are
        # bit-flipped before the install; the flip's digest gate must
        # catch it and abort before the flip.
        self.corrupt_next_chunk = False
        self._snap = None
        self._cursors = None
        self._t0 = None
        self._entry = None

    # -------------------------------------------------------- queries

    @property
    def active(self) -> bool:
        return self.stage in ("copy", "double_write")

    def _pred(self):
        p = self.plan
        lo, hi, src = p.lo, p.hi, p.src
        mask = self.router.n_shards - 1

        def inr(id128):
            h = mix_int(id128)
            return lo <= h <= hi and (h & mask) == src

        return inr

    def conflicts(self, batches) -> bool:
        """True if any id a window touches (transfer, pending, debit,
        credit) lies in the frozen range; meaningful in the copy stage
        only (after it, double-write serves the range live)."""
        if self.stage != "copy" or not batches:
            return False
        inr = self._pred()
        p = self.plan
        mask = np.uint64(self.router.n_shards - 1)
        for b in batches:
            if isinstance(b, dict):   # an SoA ev dict
                for k in ("id", "pid", "dr", "cr"):
                    hi = np.asarray(b[f"{k}_hi"], dtype=np.uint64)
                    lo = np.asarray(b[f"{k}_lo"], dtype=np.uint64)
                    nz = (hi | lo) != 0
                    h = mix_id_np(hi[nz], lo[nz])
                    if bool(np.any(in_range_np(h, p.lo, p.hi)
                                   & ((h & mask) == np.uint64(p.src)))):
                        return True
            else:                     # Transfer objects
                for t in b:
                    for i in (t.id, t.pending_id or 0,
                              t.debit_account_id or 0,
                              t.credit_account_id or 0):
                        if i and inr(i):
                            return True
        return False

    # ---------------------------------------------------------- begin

    def begin(self, state, plan: ReshardPlan, oracle=None):
        """SNAPSHOT: check, freeze and stage the copy. Returns the state
        (unchanged). Call quiesced. `oracle` (optional) adds the oracle
        leg to the digest witness and supplies the range's ring rows,
        which the device state cannot attribute."""
        assert self.stage in ("idle", "done", "aborted"), self.stage
        r = self.router
        if getattr(getattr(r, "mesh", None), "process_count", 1) > 1:
            raise ValueError("resharding runs on a mesh of one process")
        assert 0 <= plan.src < r.n_shards and 0 <= plan.dst < r.n_shards
        self.plan = plan
        self._t0 = time.monotonic()
        reverse = plan.kind == "merge_back"
        auth = plan.dst if reverse else plan.src   # the authoritative copy
        recv = plan.src if reverse else plan.dst   # the receiving shard
        if reverse:
            self._entry = self._find_entry(OVERLAY_MIGRATED)
            assert self._entry is not None, \
                "merge_back requires the range's OVERLAY_MIGRATED entry"
        with self.tracer.span(Event.reshard_stage, stage="snapshot",
                              outcome="ok"):
            snap = self._take_snapshot(state, auth, oracle)
            got = partitioned_range_digest(state, plan.lo, plan.hi,
                                           plan.src)[auth]
            if not _digest_eq(got, snap["digest"]):
                self._abort_noop("snapshot_digest",
                                 f"device {got} != snapshot pack")
            if oracle is not None:
                want = oracle_range_digest(oracle, r.a_cap, plan.lo,
                                           plan.hi, plan.src, r.n_shards)
                if not _digest_eq(got, want):
                    self._abort_noop("snapshot_oracle_digest",
                                     f"device {got} != oracle {want}")
            self._check_capacity(state, recv, snap)
        self._snap = snap
        self._cursors = dict(a=0, x=0, e=0)
        self.rows_copied = 0
        self.dw_windows = 0
        self.stage = "copy"
        return state

    def _find_entry(self, mode):
        p = self.plan
        for e in self.router.ownership.entries:
            if e[:4] == (p.lo, p.hi, p.src, p.dst) and e[4] == mode:
                return e
        return None

    def _take_snapshot(self, state, auth: int, oracle) -> dict:
        """Fetch the authoritative shard's stores to the host and filter
        the range's rows there (the canonical order kept: the source store
        is canonical and the filter keeps order)."""
        p = self.plan
        n = self.router.n_shards
        sub = state[auth]
        mask = np.uint64(n - 1)

        def member(h):
            return in_range_np(h, p.lo, p.hi) & ((h & mask)
                                                 == np.uint64(p.src))

        def sel(u64, count):
            live = np.arange(u64.shape[0]) < int(count)
            return live & member(mix_id_np(u64[:, 0], u64[:, 1]))

        a_u64 = _host(sub["accounts"]["u64"])
        a_sel = sel(a_u64, sub["accounts"]["count"])
        x_u64 = _host(sub["transfers"]["u64"])
        x_sel = sel(x_u64, sub["transfers"]["count"])
        a_rows = a_u64[a_sel]
        a_bal = _host(sub["accounts"]["bal"])[a_sel]
        x_rows = x_u64[x_sel]
        # Orphan markers live in the transfer table only (no rows): pull
        # them out of the fetched packed matrix.
        packed = _host(sub["xfer_ht"]["packed"])[:-1]
        kh = packed[:, :SLOTS].reshape(-1)
        kl = packed[:, SLOTS:2 * SLOTS].reshape(-1)
        v = packed[:, 2 * SLOTS:].reshape(-1).view(np.int64).astype(np.int32)
        o_sel = (((kh != 0) | (kl != 0)) & (v < 0)
                 & member(mix_id_np(kh, kl)))
        e_rows = np.zeros((0, EV_NCOLS), dtype=np.uint64)
        if oracle is not None:
            e_rows = self._pack_range_events(oracle)
        digest = pack_range_digest(
            dict(accounts=dict(u64=a_rows, bal=a_bal, count=len(a_rows)),
                 transfers=dict(u64=x_rows, count=len(x_rows))),
            p.lo, p.hi, p.src, n)
        return dict(a_u64=a_rows, a_bal=a_bal, x_u64=x_rows, e_u64=e_rows,
                    o_hi=kh[o_sel], o_lo=kl[o_sel], digest=digest)

    def _pack_range_events(self, sm) -> np.ndarray:
        """The range's account-event ring rows, packed from the oracle with
        dump row pointers (not canonical)."""
        from ..ops.ledger import _pack_event_rows
        from .partitioned import _record_owner_id

        inr = self._pred()
        recs = [rec for rec in sm.account_events
                if inr(_record_owner_id(sm, rec))]
        if not recs:
            return np.zeros((0, EV_NCOLS), dtype=np.uint64)
        a_cap_s = self.router.a_cap // self.router.n_shards
        return _pack_event_rows(recs, {}, {}, a_cap_s)["u64"]

    def _check_capacity(self, state, recv: int, snap: dict) -> None:
        """The whole copy's room on the receiver, proven before the first
        chunk (the margin covers double-write appends while staged)."""
        sub = state[recv]
        need = dict(a=len(snap["a_u64"]), x=len(snap["x_u64"]),
                    e=len(snap["e_u64"]))
        for k, store in (("a", "accounts"), ("x", "transfers"),
                         ("e", "events")):
            have = (sub[store]["u64"].shape[0] - 1
                    - int(sub[store]["count"]))
            if need[k] + self.capacity_margin > have:
                self._abort_noop(
                    "capacity",
                    f"store {k}: need {need[k]}+{self.capacity_margin} "
                    f"margin, have {have} on shard {recv}")

    # ----------------------------------------------------------- copy

    def on_window(self, state, batches=None, oracle=None):
        """The per-window tick (call before dispatching the window,
        quiesced). Copy stage: one chunk, or a full drain when the window
        conflicts with the frozen range. Double-write stage: count the
        boundary; flip and retire at the threshold. Otherwise a no-op."""
        if self.stage == "copy":
            if self.conflicts(batches):
                while self.stage == "copy":
                    state = self.copy_chunk(state)
            else:
                state = self.copy_chunk(state)
        elif self.stage == "double_write":
            self.dw_windows += 1
            if self.dw_windows >= self.min_double_write_windows:
                state = self.flip(state, oracle=oracle)
        return state

    def drain(self, state, oracle=None):
        """Run the migration in flight to its end (or its abort): the epoch
        check and shutdown call this, as the whole-state digest is not
        comparable while a copy is staged."""
        while self.stage == "copy":
            state = self.copy_chunk(state)
        if self.stage == "double_write":
            state = self.flip(state, oracle=oracle)
        return state

    def copy_chunk(self, state):
        """Install the next bounded chunk; after the last one, finalize the
        receiver and start double-write."""
        assert self.stage == "copy", self.stage
        p, snap, cur = self.plan, self._snap, self._cursors
        C = self.chunk_rows
        recv = p.src if p.kind == "merge_back" else p.dst
        dev = self.router.mesh.devices[recv]

        def take(mat, key, ncols):
            k = min(C, len(mat) - cur[key])
            rows = np.zeros((C, ncols), dtype=np.uint64)
            if k > 0:
                rows[:k] = mat[cur[key]:cur[key] + k]
            cur[key] += k
            return rows, k

        with self.tracer.span(Event.reshard_stage, stage="copy",
                              outcome="ok"):
            a_rows, a_k = take(snap["a_u64"], "a", AC_NCOLS)
            a_bal = np.zeros((C, snap["a_bal"].shape[1]), dtype=np.uint64)
            if a_k > 0:
                a_bal[:a_k] = snap["a_bal"][cur["a"] - a_k:cur["a"]]
            x_rows, x_k = take(snap["x_u64"], "x", XF_NCOLS)
            e_rows, e_k = take(snap["e_u64"], "e", EV_NCOLS)
            if self.corrupt_next_chunk and x_k > 0:
                # Fault injection: flip amount bits in the staged rows only.
                # The source stays right, so the flip's gate sees source !=
                # target and must abort.
                x_rows[:x_k, XF_U64_IDX["amt_lo"]] ^= np.uint64(0xA5)
                self.corrupt_next_chunk = False
            _install_chunk(state[recv], carrier(a_rows, dev),
                           carrier(a_bal, dev), a_k, carrier(x_rows, dev),
                           x_k, carrier(e_rows, dev), e_k)
            copied = a_k + x_k + e_k
            self.rows_copied += copied
            if copied:
                self.tracer.count(Event.reshard_rows_copied, value=copied)
        if (cur["a"] >= len(snap["a_u64"]) and cur["x"] >= len(snap["x_u64"])
                and cur["e"] >= len(snap["e_u64"])):
            state = self._activate_double_write(state)
        return state

    def _activate_double_write(self, state):
        """Finalize the receiver and swap in the copy-catchup overlay
        (forward: a DOUBLE_WRITE entry; merge-back: the MIGRATED entry
        turns RETURNING). Traffic on the range resumes, its writes landing
        on both copies."""
        p, snap = self.plan, self._snap
        recv = p.src if p.kind == "merge_back" else p.dst
        dev = self.router.mesh.devices[recv]
        n_o = len(snap["o_hi"])
        o_cap = 1 << max(0, (max(1, n_o) - 1).bit_length())
        o_hi = np.zeros(o_cap, dtype=np.uint64)
        o_lo = np.zeros(o_cap, dtype=np.uint64)
        o_hi[:n_o] = snap["o_hi"]
        o_lo[:n_o] = snap["o_lo"]
        ok = _finalize_shard(state[recv], carrier(o_hi, dev),
                             carrier(o_lo, dev), n_o)
        if not bool(ok):
            return self._abort_device("table_capacity",
                                      f"receiver shard {recv}", state)
        r = self.router
        if p.kind == "merge_back":
            table = r.ownership.transition(self._entry, OVERLAY_RETURNING)
            self._entry = (p.lo, p.hi, p.src, p.dst, OVERLAY_RETURNING)
        else:
            table = r.ownership.with_entry(p.lo, p.hi, p.src, p.dst,
                                           OVERLAY_DOUBLE_WRITE)
            self._entry = (p.lo, p.hi, p.src, p.dst, OVERLAY_DOUBLE_WRITE)
        r.set_ownership(table)
        self.tracer.gauge(Event.reshard_overlay_active, len(table.entries))
        self.stage = "double_write"
        return state

    # ----------------------------------------------------------- flip

    def _active_entries(self, table) -> int:
        return sum(1 for e in table.entries if e[4] != OVERLAY_MIGRATED)

    def flip(self, state, oracle=None):
        """The witness-gated ownership switch (call quiesced, at a window
        boundary). The source's and the target's range digests, content
        and row counts, must be equal, and the oracle's when held. Clean:
        ownership moves and the stale copy retires at the same boundary.
        Mismatch: abort (overlay reverted, staged copy evicted, artifact
        dumped)."""
        assert self.stage == "double_write", self.stage
        p, r = self.plan, self.router
        comps = partitioned_range_digest(state, p.lo, p.hi, p.src)
        src_d, dst_d = comps[p.src], comps[p.dst]
        if not _digest_eq(src_d, dst_d):
            with self.tracer.span(Event.reshard_stage, stage="flip",
                                  outcome="abort"):
                return self._abort_device(
                    "digest_mismatch", f"src {src_d} != dst {dst_d}", state)
        if oracle is not None:
            want = oracle_range_digest(oracle, r.a_cap, p.lo, p.hi, p.src,
                                       r.n_shards)
            if not _digest_eq(src_d, want):
                with self.tracer.span(Event.reshard_stage, stage="flip",
                                      outcome="abort"):
                    return self._abort_device(
                        "oracle_digest_mismatch",
                        f"device {src_d} != oracle {want}", state)
        with self.tracer.span(Event.reshard_stage, stage="flip",
                              outcome="ok"):
            if p.kind == "merge_back":
                table = r.ownership.without_entry(self._entry)
            else:
                table = r.ownership.transition(self._entry, OVERLAY_MIGRATED)
            r.set_ownership(table)
            self.tracer.gauge(Event.reshard_overlay_active,
                              self._active_entries(table))
        return self._retire(state)

    def _retire(self, state):
        """Evict the stale copy (the source forward, the receiver's old
        authority on a merge-back) at the flip's boundary: no window sees
        both copies readable."""
        p = self.plan
        stale = p.dst if p.kind == "merge_back" else p.src
        with self.tracer.span(Event.reshard_stage, stage="retire",
                              outcome="ok"):
            _evict_range(state[stale], p.lo, p.hi, self.router.n_shards,
                         p.src)
        self.migrations.append(dict(
            kind=p.kind, lo=p.lo, hi=p.hi, src=p.src, dst=p.dst,
            rows_copied=self.rows_copied,
            double_write_windows=self.dw_windows,
            duration_s=round(time.monotonic() - self._t0, 6)))
        self._reset("done")
        return state

    # ---------------------------------------------------------- abort

    def _abort_noop(self, reason: str, detail: str):
        """Abort before anything was staged on the device."""
        self._record_abort(reason, detail)
        raise MigrationAborted(reason, detail)

    def _revert_entry(self) -> None:
        """Revert the overlay entry, if live: a RETURNING merge-back goes
        back to MIGRATED (its owner before the copy), a forward entry
        goes."""
        r = self.router
        if self._entry is None or self._entry not in r.ownership.entries:
            return
        if self.plan.kind == "merge_back":
            table = r.ownership.transition(self._entry, OVERLAY_MIGRATED)
        else:
            table = r.ownership.without_entry(self._entry)
        r.set_ownership(table)
        self.tracer.gauge(Event.reshard_overlay_active,
                          self._active_entries(table))

    def _abort_device(self, reason: str, detail: str, state):
        """Abort with staged rows on the receiver: revert the overlay,
        evict the staged copy, dump the artifact, raise (the state rides
        on the exception)."""
        p, r = self.plan, self.router
        recv = p.src if p.kind == "merge_back" else p.dst
        self._revert_entry()
        _evict_range(state[recv], p.lo, p.hi, r.n_shards, p.src)
        self._record_abort(reason, detail)
        err = MigrationAborted(reason, detail)
        err.state = state
        raise err

    def _record_abort(self, reason: str, detail: str) -> None:
        self.aborts.append(dict(reason=reason, detail=detail[:200],
                                stage=self.stage,
                                rows_copied=self.rows_copied))
        self.router.flight.record(
            window=getattr(self.router, "_window_seq", 0),
            route="reshard_abort", reason=reason, detail=detail[:200],
            stage=self.stage)
        self.router.flight.dump(f"reshard_abort_{reason}")
        self.tracer.count(Event.serving_recoveries, cause="reshard_abort")
        self._reset("aborted")

    def on_recovery(self) -> None:
        """A crash or quarantine mid-migration: revert the overlay entry
        (a migration before its flip serves from its old owner again)
        without device work: the caller rebuilds the whole state from the
        oracle (`PartitionedRouter.resync`), which places every range by
        the reverted table. After a flip there is nothing to revert."""
        if not self.active:
            return
        self._revert_entry()
        self._record_abort("recovery", "crash/quarantine mid-migration")

    def _reset(self, terminal: str) -> None:
        self.stage = terminal
        self._snap = None
        self._cursors = None
        self._entry = None
        self.plan = None


# --------------------------------------------------- hot-range detector

@dataclass
class HotRangeDetector:
    """Propose-only split planner: folds per-shard routed-event counts and
    a decayed per-account hash histogram into a split proposal for the
    hottest shard, or the `unsplittable` verdict: one account carrying the
    load, which no hash range smaller than the whole shard isolates (no
    proposal then; the verdict names the account's hash; the remedy is
    lane parallelism within the account's commit lane, not placement).

    Enacting a proposal is the driver's decision; the detector never
    changes ownership."""

    n_shards: int
    hot_ratio: float = 2.0
    top_frac: float = 0.5
    decay: float = 0.5
    min_events: int = 64
    max_tracked: int = 4096
    cooldown_windows: int = 4
    _loads: np.ndarray = field(default=None, repr=False)
    _hashes: dict = field(default_factory=dict, repr=False)
    _cooldown: int = 0

    def __post_init__(self):
        assert self.n_shards & (self.n_shards - 1) == 0, self.n_shards
        self._loads = np.zeros(self.n_shards, dtype=np.float64)

    def observe_window(self, evs) -> None:
        """Fold one window's account traffic (SoA ev dicts or Transfer
        object batches): every touched account hash lands in the per-shard
        load vector and the hash histogram."""
        hs = []
        for b in evs:
            if isinstance(b, dict):
                for k in ("dr", "cr"):
                    hs.append(mix_id_np(b[f"{k}_hi"], b[f"{k}_lo"]))
            else:
                hs.append(np.array(
                    [mix_int(i) for t in b
                     for i in (t.debit_account_id, t.credit_account_id)
                     if i], dtype=np.uint64))
        if not hs:
            return
        zero = mix_int(0)
        h = np.concatenate([x[x != zero] if x.size else x for x in hs])
        if h.size == 0:
            return
        shards = (h & np.uint64(self.n_shards - 1)).astype(np.int64)
        self._loads *= self.decay
        np.add.at(self._loads, shards, 1.0)
        for k in self._hashes:
            self._hashes[k] *= self.decay
        uniq, cnt = np.unique(h, return_counts=True)
        for hv, c in zip(uniq.tolist(), cnt.tolist()):
            self._hashes[hv] = self._hashes.get(hv, 0.0) + c
        if len(self._hashes) > self.max_tracked:
            keep = sorted(self._hashes.items(), key=lambda kv: -kv[1])
            self._hashes = dict(keep[:self.max_tracked // 2])
        if self._cooldown > 0:
            self._cooldown -= 1

    def propose(self) -> dict | None:
        """None while balanced (or cooling down, or under-sampled); else
        {"verdict": "split", "plan": ReshardPlan, ...} or {"verdict":
        "unsplittable", ...}."""
        total = float(self._loads.sum())
        if total < self.min_events or self._cooldown > 0:
            return None
        mean = total / self.n_shards
        hot = int(self._loads.argmax())
        if self._loads[hot] < self.hot_ratio * mean:
            return None
        shard_hashes = sorted(
            (hv, w) for hv, w in self._hashes.items()
            if (hv & (self.n_shards - 1)) == hot)
        shard_w = sum(w for _, w in shard_hashes)
        if not shard_hashes or shard_w <= 0:
            return None
        top_hash, top_w = max(shard_hashes, key=lambda kv: kv[1])
        self._cooldown = self.cooldown_windows
        if top_w / shard_w >= self.top_frac:
            return dict(verdict="unsplittable", shard=hot,
                        hot_hash=int(top_hash),
                        fraction=round(top_w / shard_w, 4),
                        note="single hot account dominates: no hash "
                             "range isolates it — needs AT2 lane "
                             "parallelism, not placement")
        # Split at the weighted median hash (about half the observed load
        # moves) to the coldest shard.
        acc = 0.0
        mid = shard_hashes[-1][0]
        for hv, w in shard_hashes:
            acc += w
            if acc >= shard_w / 2:
                mid = hv
                break
        dst = int(self._loads.argmin())
        if dst == hot:
            return None
        plan = ReshardPlan(lo=0, hi=int(mid), src=hot, dst=dst,
                           kind="split")
        return dict(verdict="split", shard=hot, plan=plan,
                    load=float(self._loads[hot]), mean=mean)
