"""Lazy columnar host mirror: the serving drain without per-event objects.

A port of the JAX package's `ops/lazy_mirror.py`. The write-through
drain (`ledger.DeviceLedger.drain_mirror`) is COLUMNAR: a drained chunk
registers keys and keeps the fetched numpy columns as the value arena;
Python objects are built only when a reader actually asks for one.

  - `LazyTransferDict` — the mirror's transfers container. Point reads
    (idempotency probes, pending lookups, client lookups) materialize one
    row; bulk readers (values()/items()/==) materialize everything, which
    only happens on rare paths (state-sync snapshot encode, host-engine
    query index builds, parity tests).
  - `DeltaChunk` — one drained delta's columns (t/e/der, the
    _delta_fetch_start layout) + row -> object builders that reproduce the
    eager drain's values field-for-field.
  - `LazyEventRecord` — account_events entry backed by a chunk row;
    builds its AccountEventRecord (including the two per-event account
    snapshots) on first attribute access.
  - `apply_account_finals` — vectorized last-writer account update: one
    new Account per TOUCHED account per chunk instead of two `__dict__`
    copies per event.

Every value a reader can observe is identical to an eager per-event
drain's (tests/test_torch_write_through.py holds these containers
against the JAX package's on the same chunks).
Reference: the groove object cache materializes on demand too —
src/lsm/groove.zig:885 `get` pulls from cache/tree, objects are not built
at commit time (commit is the cheap part, src/state_machine.zig:2564).
"""

from __future__ import annotations

import numpy as np

from ..oracle.state_machine import AccountEventRecord, DirtyDict
from ..types import Account, Transfer, TransferPendingStatus

_P = TransferPendingStatus
_P_BY = {int(m): m for m in _P}
_TFLAGS_NONE = 0xFFFFFFFF


class DeltaChunk:
    """One drained fast-batch delta: the fetched numpy columns plus the
    owning mirror (for account immutable fields and pending-transfer
    resolution). Columns are the _delta_fetch_start layout: `t` = xf_named
    transfer rows, `e` = ev_named event rows, `der` = derived gathers
    (touched account ids, pending timestamps), each in the JAX package's
    host dtypes (u64 lanes as uint64, 32-bit lanes as uint32/int32)."""

    __slots__ = ("t", "e", "der", "sm", "ids", "_rows")

    def __init__(self, t, e, der, sm, ids=None):
        self.t, self.e, self.der, self.sm = t, e, der, sm
        # Created-transfer ids in row order; the id -> row map is built
        # C-level on the first point read (most chunks never see one).
        self.ids = ids
        self._rows = None

    def row_of(self, tid: int) -> int:
        rows = self._rows
        if rows is None:
            rows = self._rows = dict(zip(self.ids, range(len(self.ids))))
        return rows[tid]

    def transfer(self, k: int) -> Transfer:
        # Shared row builder (same xf_named layout as the device rebuild
        # path). The import is deferred: ledger imports this module.
        from .ledger import _transfer_from_row

        return _transfer_from_row(self.t, k, None)

    def account(self, side: str, k: int) -> Account:
        """The side's account snapshot as of AFTER event k — balances and
        flags from the event columns, immutable fields from the current
        account object (they never change across transfer application)."""
        e, der = self.e, self.der

        def u(hi, lo):
            return (int(hi[k]) << 64) | int(lo[k])

        aid = u(der[side + "_id_hi"], der[side + "_id_lo"])
        cur = self.sm.accounts[aid]
        new = Account.__new__(Account)
        new.__dict__.update(cur.__dict__)
        new.debits_pending = u(e[side + "_dp_hi"], e[side + "_dp_lo"])
        new.debits_posted = u(e[side + "_dpos_hi"], e[side + "_dpos_lo"])
        new.credits_pending = u(e[side + "_cp_hi"], e[side + "_cp_lo"])
        new.credits_posted = u(e[side + "_cpos_hi"], e[side + "_cpos_lo"])
        new.flags = int(e[side + "_flags"][k])
        return new

    def event(self, k: int) -> AccountEventRecord:
        e, der, sm = self.e, self.der, self.sm

        def u(hi, lo):
            return (int(hi[k]) << 64) | int(lo[k])

        pstat = _P_BY[int(e["pstat"][k])]
        p_obj = None
        if pstat in (_P.posted, _P.voided):
            pts = int(der["p_ts"][k])
            p_obj = sm.transfers[sm.transfer_by_timestamp[pts]]
        tflags_raw = int(e["tflags"][k])
        return AccountEventRecord(
            timestamp=int(e["ts"][k]),
            dr_account=self.account("dr", k),
            cr_account=self.account("cr", k),
            transfer_flags=None if tflags_raw == _TFLAGS_NONE else tflags_raw,
            transfer_pending_status=pstat,
            transfer_pending=p_obj,
            amount_requested=u(e["areq_hi"], e["areq_lo"]),
            amount=u(e["amt_hi"], e["amt_lo"]),
        )


class LazyEventRecord:
    """account_events entry that builds its AccountEventRecord on demand.
    `timestamp` is served straight from the chunk column (prune/scan
    filters touch only it); any other field materializes the record."""

    __slots__ = ("_c", "_k", "_real")

    def __init__(self, chunk: DeltaChunk, k: int):
        self._c, self._k, self._real = chunk, k, None

    @property
    def timestamp(self) -> int:
        real = self._real
        if real is not None:
            return real.timestamp
        return int(self._c.e["ts"][self._k])

    def _build(self) -> AccountEventRecord:
        real = self._real
        if real is None:
            real = self._real = self._c.event(self._k)
        return real

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._build(), name)

    def __eq__(self, other):
        if isinstance(other, LazyEventRecord):
            other = other._build()
        return self._build() == other

    def __ne__(self, other):
        return not self.__eq__(other)

    __hash__ = None

    def __repr__(self):
        return repr(self._build())


class LazyEventList:
    """account_events container that stores drained chunks as SEGMENTS
    instead of per-event proxy objects — the drain appends one segment
    per chunk (O(1)), and element access builds LazyEventRecord proxies
    on demand. Supports exactly the list surface the codebase uses:
    append/extend, len/iter/getitem (int + slice), del-prefix (prune),
    del-suffix (scope rollback), bool, ==.

    Segments: ("real", [records...]) for eagerly-appended records
    (oracle fallback path, recovery), ("lazy", chunk, start, n) for a
    drained chunk's rows [start, start+n)."""

    __slots__ = ("_segs", "_len")

    def __init__(self, items=()):
        self._segs: list = []
        self._len = 0
        if items:
            self._segs.append(("real", list(items)))
            self._len = len(self._segs[0][1])

    @classmethod
    def adopt(cls, src) -> "LazyEventList":
        if isinstance(src, cls):
            return src
        return cls(src)

    # --------------------------------------------------------- mutation

    def append(self, rec) -> None:
        segs = self._segs
        if segs and segs[-1][0] == "real":
            segs[-1][1].append(rec)
        else:
            segs.append(("real", [rec]))
        self._len += 1

    def extend(self, iterable) -> None:
        for rec in iterable:
            self.append(rec)

    def extend_lazy(self, chunk: DeltaChunk, n: int) -> None:
        if n:
            self._segs.append(("lazy", chunk, 0, n))
            self._len += n

    def __delitem__(self, key) -> None:
        if not isinstance(key, slice) or key.step is not None:
            raise TypeError("LazyEventList supports slice deletion only")
        start, stop, _ = key.indices(self._len)
        if start == 0 and stop < self._len:
            self._drop_prefix(stop)
        elif stop == self._len:
            self._drop_suffix(start)
        else:
            raise ValueError("only prefix/suffix deletion is supported")

    def _drop_prefix(self, k: int) -> None:
        segs = self._segs
        while k > 0 and segs:
            seg = segs[0]
            size = len(seg[1]) if seg[0] == "real" else seg[3]
            if size <= k:
                segs.pop(0)
                k -= size
                self._len -= size
            elif seg[0] == "real":
                del seg[1][:k]
                self._len -= k
                k = 0
            else:
                segs[0] = ("lazy", seg[1], seg[2] + k, seg[3] - k)
                self._len -= k
                k = 0

    def _drop_suffix(self, keep: int) -> None:
        segs = self._segs
        drop = self._len - keep
        while drop > 0 and segs:
            seg = segs[-1]
            size = len(seg[1]) if seg[0] == "real" else seg[3]
            if size <= drop:
                segs.pop()
                drop -= size
                self._len -= size
            elif seg[0] == "real":
                del seg[1][size - drop:]
                self._len -= drop
                drop = 0
            else:
                segs[-1] = ("lazy", seg[1], seg[2], seg[3] - drop)
                self._len -= drop
                drop = 0

    # ------------------------------------------------------------ reads

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self):
        for seg in self._segs:
            if seg[0] == "real":
                yield from seg[1]
            else:
                _, chunk, start, n = seg
                for k in range(start, start + n):
                    yield LazyEventRecord(chunk, k)

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self._len)
            if step != 1:
                raise TypeError("LazyEventList slices must be contiguous")
            out = []
            pos = 0
            for seg in self._segs:
                if pos >= stop:
                    break
                size = len(seg[1]) if seg[0] == "real" else seg[3]
                lo = max(start, pos)
                hi = min(stop, pos + size)
                if lo < hi:
                    if seg[0] == "real":
                        out.extend(seg[1][lo - pos:hi - pos])
                    else:
                        _, chunk, s0, _ = seg
                        out.extend(
                            LazyEventRecord(chunk, s0 + k - pos)
                            for k in range(lo, hi))
                pos += size
            return out
        if key < 0:
            key += self._len
        if not 0 <= key < self._len:
            raise IndexError(key)
        for seg in self._segs:
            size = len(seg[1]) if seg[0] == "real" else seg[3]
            if key < size:
                if seg[0] == "real":
                    return seg[1][key]
                return LazyEventRecord(seg[1], seg[2] + key)
            key -= size
        raise IndexError(key)  # unreachable

    def __eq__(self, other):
        try:
            if len(other) != self._len:
                return False
        except TypeError:
            return NotImplemented
        return all(a == b for a, b in zip(self, other))

    def __ne__(self, other):
        eq = self.__eq__(other)
        if eq is NotImplemented:
            return eq
        return not eq

    __hash__ = None

    def __repr__(self):
        return f"LazyEventList(len={self._len}, segs={len(self._segs)})"


class LazyTransferDict(DirtyDict):
    """DirtyDict whose unmaterialized values live as (chunk, row) refs in
    `_lazy`. Materialization is NOT a mutation: it never touches the
    dirty channels. All mutation paths (fallback inserts, scope
    rollbacks) keep exact DirtyDict semantics."""

    def __init__(self, *args):
        super().__init__(*args)
        self._lazy: dict = {}

    @classmethod
    def adopt(cls, src: DirtyDict) -> "LazyTransferDict":
        """Convert an eager DirtyDict in place-ish: same items, same dirty
        channel IDENTITY (the flusher may hold the sets)."""
        if isinstance(src, cls):
            return src
        out = cls()
        dict.update(out, src)
        out.dirty = src.dirty
        out.dirty_dev = src.dirty_dev
        out.track_dev = src.track_dev
        return out

    # ------------------------------------------------------------- reads

    def _materialize(self, key):
        chunk = self._lazy.pop(key)
        obj = chunk.transfer(chunk.row_of(key))
        dict.__setitem__(self, key, obj)
        return obj

    def materialize_all(self) -> None:
        # FIFO (registration == commit order): dict insertion order is an
        # implicit contract some readers still hold (e.g. values() scans),
        # though order-SENSITIVE consumers must iterate by_timestamp —
        # a point read already moves one key out of commit position.
        lazy = self._lazy
        if not lazy:
            return
        setitem = dict.__setitem__
        for key, chunk in lazy.items():
            setitem(self, key, chunk.transfer(chunk.row_of(key)))
        lazy.clear()

    def __getitem__(self, key):
        try:
            return dict.__getitem__(self, key)
        except KeyError:
            if key in self._lazy:
                return self._materialize(key)
            raise

    def get(self, key, default=None):
        try:
            return dict.__getitem__(self, key)
        except KeyError:
            if key in self._lazy:
                return self._materialize(key)
            return default

    def __contains__(self, key):
        return dict.__contains__(self, key) or key in self._lazy

    def __len__(self):
        return dict.__len__(self) + len(self._lazy)

    def __iter__(self):
        yield from dict.__iter__(self)
        yield from list(self._lazy)

    def keys(self):
        if not self._lazy:
            return dict.keys(self)
        return dict.keys(self) | self._lazy.keys()

    def values(self):
        self.materialize_all()
        return dict.values(self)

    def items(self):
        self.materialize_all()
        return dict.items(self)

    def copy(self):
        self.materialize_all()
        return dict(self)

    def __eq__(self, other):
        self.materialize_all()
        if isinstance(other, LazyTransferDict):
            other.materialize_all()
        return dict.__eq__(self, other)

    def __ne__(self, other):
        eq = self.__eq__(other)
        if eq is NotImplemented:
            return eq
        return not eq

    __hash__ = None

    def __repr__(self):
        return (f"LazyTransferDict({dict.__len__(self)} real, "
                f"{len(self._lazy)} lazy)")

    # --------------------------------------------------------- mutations

    def register(self, ids: list, chunk: DeltaChunk) -> None:
        """Bulk-add one chunk's created transfers as lazy rows. Created
        ids are globally unique (the kernel's idempotency predicate), so
        no key can already exist on either side."""
        from itertools import repeat

        self._lazy.update(zip(ids, repeat(chunk)))
        self.dirty.update(ids)

    def __delitem__(self, key):
        if key in self._lazy:
            self.dirty.add(key)
            if self.track_dev:
                self.dirty_dev.add(key)
            del self._lazy[key]
            return
        super().__delitem__(key)

    def pop(self, key, *default):
        if key in self._lazy:
            self.dirty.add(key)
            if self.track_dev:
                self.dirty_dev.add(key)
            chunk = self._lazy.pop(key)
            return chunk.transfer(chunk.row_of(key))
        return super().pop(key, *default)

    def setdefault(self, key, default=None):
        if key in self:
            return self[key]
        self[key] = default
        return default


def apply_account_finals(sm, e, der) -> list:
    """Vectorized account write-back for one drained chunk: compute each
    touched account's FINAL post-chunk state (last event wins — balances
    are cumulative, so the last per-account event row carries the final
    values), build ONE new Account object per account whose state
    actually changed, and return the changed ids for bulk dirty marking.

    Equivalent to the eager per-event stores: an account whose final
    state equals its pre-chunk state saw only no-op events (zero-amount,
    no pending release, no closed-flag toggle), exactly the events the
    eager drain's _put_account conditions skipped."""
    n = len(der["dr_id_hi"])
    n2 = 2 * n

    def ilv(a, b):
        out = np.empty(n2, dtype=a.dtype)
        out[0::2] = a
        out[1::2] = b
        return out

    hi = ilv(np.asarray(der["dr_id_hi"]), np.asarray(der["cr_id_hi"]))
    lo = ilv(np.asarray(der["dr_id_lo"]), np.asarray(der["cr_id_lo"]))
    order = np.lexsort((np.arange(n2), lo, hi))
    shi, slo = hi[order], lo[order]
    last = np.empty(n2, dtype=bool)
    last[-1] = True
    last[:-1] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
    sel = order[last]

    aid = [(h << 64) | l
           for h, l in zip(hi[sel].tolist(), lo[sel].tolist())]

    def balcol(field):
        vals = {}
        for side in ("dr", "cr"):
            h = np.asarray(e[f"{side}_{field}_hi"])
            l = np.asarray(e[f"{side}_{field}_lo"])
            vals[side] = (h, l)
        h = ilv(vals["dr"][0], vals["cr"][0])[sel]
        l = ilv(vals["dr"][1], vals["cr"][1])[sel]
        return [(int(a) << 64) | int(b)
                for a, b in zip(h.tolist(), l.tolist())]

    dp = balcol("dp")
    dpos = balcol("dpos")
    cp = balcol("cp")
    cpos = balcol("cpos")
    flags = ilv(np.asarray(e["dr_flags"]),
                np.asarray(e["cr_flags"]))[sel].tolist()

    accounts = sm.accounts
    changed: list = []
    _new = Account.__new__
    aset = dict.__setitem__
    for i in range(len(aid)):
        a = aid[i]
        prev = accounts[a]
        if (prev.debits_pending == dp[i]
                and prev.debits_posted == dpos[i]
                and prev.credits_pending == cp[i]
                and prev.credits_posted == cpos[i]
                and prev.flags == flags[i]):
            continue
        new = _new(Account)
        new.__dict__.update(prev.__dict__)
        new.debits_pending = dp[i]
        new.debits_posted = dpos[i]
        new.credits_pending = cp[i]
        new.credits_posted = cpos[i]
        new.flags = flags[i]
        aset(accounts, a, new)
        changed.append(a)
    return changed
