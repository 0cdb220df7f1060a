"""The ledger state digest: the parity witness of the port.

A port of the fold in the JAX package's `ops/state_epoch.py`
(`_mix64`, `_matrix_digest`, `_digest_components`,
`device_state_digest`), on int64-carried u64 tensors. It computes the
same bits as the JAX package's `device_state_digest` and
`oracle_state_digest`, so a port state compares directly with a JAX
state or an oracle state.

The host side (`pack_oracle_state`, `oracle_state_digest`, `combine`,
`diverging_components`) is the JAX package's too: an oracle state packed
through the ledger's own row packers and folded the same way, the
write-through mirror's check against the card. So are the partitioned
digests (`partitioned_state_digest`, `pack_oracle_state_partitioned`,
`partitioned_oracle_digest`): one fold a shard, wrap-summed; and the
range digests of live resharding (`partitioned_range_digest`,
`oracle_range_digest`, `sum_range_components`): a position-independent
fold over one hash range, one a shard.

Covered: the accounts u64 matrix, the balance-limb matrix, the
transfers u64 matrix (minus the non-canonical `expires` and row-cache
columns) and the scalar vector (row counts, key maxima, commit_ts).
Excluded: the hash tables, the event ring and pulse_next.

The fold is sum-of-mixed-rows: per row, a column-Horner fold is mixed
(splitmix64 finalizer) with the row index and a per-component salt,
rows at/after `count` are zeroed, and the rows are summed with u64
wrap-around.
"""

from __future__ import annotations

import numpy as np
import torch

from .ev_layout import XF_NCOLS, XF_P32_POS, XF_U64_IDX
from .u64 import MASK64, s64, srl, u64

_PHI = s64(0x9E3779B97F4A7C15)
_MIX1 = s64(0xBF58476D1CE4E5B9)
_MIX2 = s64(0x94D049BB133111EB)

AC_COL_MASKS = None


def _xf_col_masks() -> tuple:
    masks = [MASK64] * XF_NCOLS
    masks[XF_U64_IDX["expires"]] = 0
    masks[XF_P32_POS["dr_row"][0]] = 0  # the (dr_row, cr_row) word
    return tuple(masks)


XF_COL_MASKS = _xf_col_masks()


def _mix64(x):
    """splitmix64 finalizer over an int64-carried u64 tensor."""
    x = x ^ srl(x, 30)
    x = x * _MIX1
    x = x ^ srl(x, 27)
    x = x * _MIX2
    x = x ^ srl(x, 31)
    return x


def _matrix_digest(m, count, col_masks, salt: int):
    """Sum over rows < count of mix(column-Horner(row) ^ row-index ^ salt)
    as a 0-dim int64 tensor (u64 bits)."""
    rows = m.shape[0]
    acc = torch.zeros(rows, dtype=torch.int64, device=m.device)
    for j in range(m.shape[1]):
        mask = MASK64 if col_masks is None else col_masks[j]
        if mask == 0:
            continue
        col = m[:, j]
        if mask != MASK64:
            col = col & s64(mask)
        acc = acc * _PHI + col
    iota = torch.arange(rows, dtype=torch.int64, device=m.device)
    rowd = _mix64(acc ^ (iota * _PHI) ^ s64(salt))
    live = iota < count
    return torch.sum(torch.where(live, rowd, 0))


_SALT = {"accounts_u64": 0xA1, "accounts_bal": 0xB2,
         "transfers_u64": 0xC3, "scalars": 0xD4}


def _digest_components(state: dict) -> dict:
    acc = state["accounts"]
    xfr = state["transfers"]
    comps = {
        "accounts_u64": _matrix_digest(
            acc["u64"], acc["count"], AC_COL_MASKS, _SALT["accounts_u64"]),
        "accounts_bal": _matrix_digest(
            acc["bal"], acc["count"], None, _SALT["accounts_bal"]),
        "transfers_u64": _matrix_digest(
            xfr["u64"], xfr["count"], XF_COL_MASKS,
            _SALT["transfers_u64"]),
    }
    scalars = torch.stack([
        state["acct_key_max"].to(torch.int64),
        state["xfer_key_max"].to(torch.int64),
        state["commit_ts"].to(torch.int64),
        acc["count"].to(torch.int64),
        xfr["count"].to(torch.int64),
    ])
    comps["scalars"] = _matrix_digest(scalars[None, :], 1, None,
                                      _SALT["scalars"])
    return comps


def device_state_digest(state: dict) -> dict:
    """Digest a port ledger state: named u64 component digests as Python
    ints (one host sync)."""
    comps = _digest_components(state)
    names = sorted(comps)
    vals = torch.stack([comps[k] for k in names]).cpu().tolist()
    return {k: u64(v) for k, v in zip(names, vals)}


# ------------------------------------------------------ host digests

def pack_oracle_state(sm, a_cap: int) -> dict:
    """Pack an oracle state's digested components through the ledger's
    canonical host packers (the `from_host` rebuild path), as numpy
    uint64 matrices of the live rows only (the fold is capacity-blind).
    Accounts in applied-timestamp order, transfers in commit order: the
    device's row order."""
    from ..types import TransferPendingStatus
    from .ev_layout import AC_NCOLS
    from .ledger import _pack_account_rows, _pack_transfer_rows

    accounts = sorted(sm.accounts.values(), key=lambda a: a.timestamp)
    if accounts:
        a_u64, a_bal = _pack_account_rows(accounts)
    else:
        a_u64 = np.zeros((0, AC_NCOLS), dtype=np.uint64)
        a_bal = np.zeros((0, 16), dtype=np.uint64)
    acct_row = {a.id: r for r, a in enumerate(accounts)}
    transfers = [sm.transfers[tid]
                 for tid in sm.transfer_by_timestamp.values()]
    if transfers:
        x_u64 = _pack_transfer_rows(
            transfers,
            lambda o: int(sm.pending_status.get(
                o.timestamp, TransferPendingStatus.none)),
            lambda aid, dump: acct_row.get(aid, dump),
            a_cap)
    else:
        x_u64 = np.zeros((0, XF_NCOLS), dtype=np.uint64)
    return dict(
        accounts=dict(u64=a_u64, bal=a_bal,
                      count=np.int32(len(accounts))),
        transfers=dict(u64=x_u64, count=np.int32(len(transfers))),
        acct_key_max=np.uint64(sm.accounts_key_max or 0),
        xfer_key_max=np.uint64(sm.transfers_key_max or 0),
        commit_ts=np.uint64(sm.commit_timestamp),
    )


def _host_tensor(a):
    """A host array of u64 values (or counts) -> its int64 CPU tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.uint64).view(
        np.int64).copy())


def _host_pack_state(pack: dict) -> dict:
    """A host pack's stores (`pack_oracle_state`'s, or a snapshot's rows)
    as CPU tensors."""
    return {store: {k: _host_tensor(v) for k, v in pack[store].items()}
            for store in ("accounts", "transfers")}


def _pack_digest(pack: dict) -> dict:
    """The fold over a host pack (`pack_oracle_state`'s), on CPU
    tensors."""
    state = _host_pack_state(pack)
    for k in ("acct_key_max", "xfer_key_max", "commit_ts"):
        state[k] = _host_tensor(pack[k])
    return device_state_digest(state)


def oracle_state_digest(sm, a_cap: int) -> dict:
    """The expected digest of an oracle state: the same fold over its
    canonical pack (on CPU tensors), bit-comparable with
    `device_state_digest`."""
    return _pack_digest(pack_oracle_state(sm, a_cap))


def _mix_int(x: int) -> int:
    x &= MASK64
    x ^= x >> 30
    x = (x * u64(_MIX1)) & MASK64
    x ^= x >> 27
    x = (x * u64(_MIX2)) & MASK64
    x ^= x >> 31
    return x


def combine(comps: dict) -> int:
    """One u64 digest over the component dict (key-sorted, so dict
    ordering never matters)."""
    d = 0
    for k in sorted(comps):
        d = _mix_int(d ^ (int(comps[k]) & MASK64))
    return d


def diverging_components(got: dict, want: dict) -> list[str]:
    """Component names where two digest dicts disagree."""
    return sorted(k for k in set(got) | set(want)
                  if got.get(k) != want.get(k))


# ------------------------------------------------- partitioned states
# (parallel/partitioned.py: every store sharded by the id hash.) The fold
# extends shard-then-sum: each shard digests its own rows at its own row
# indices (the indices the per-shard oracle pack assigns in the same
# shard-then-sort order), and the per-component digests wrap-sum across
# shards. Addition keeps the combination order-free, so the device fold
# (one a shard) and the host fold agree bit for bit, and both equal the
# JAX package's.

def partitioned_state_digest(state, mesh=None) -> dict:
    """Digest a partitioned state (the tuple of per-shard state dicts):
    each shard's components folded on its device, wrap-summed per
    component on the host. On a multi-process `mesh` the state holds this
    process's shards only, and the sums wrap-sum across the processes
    (`shard_utils.psum_host`)."""
    total: dict = {}
    for sub in state:
        for k, v in device_state_digest(sub).items():
            total[k] = (total.get(k, 0) + v) & MASK64
    if mesh is not None and mesh.process_count > 1:
        from ..parallel.shard_utils import psum_host

        names = sorted(total)
        sums = psum_host(mesh, [total[k] for k in names])
        total = dict(zip(names, sums))
    return total


def pack_oracle_state_partitioned(sm, a_cap: int, n_shards: int,
                                  overlay: tuple = ()) -> list:
    """Per-shard canonical packs of an oracle state: objects assigned by
    the ownership hash the kernels use (`shard_utils.owner_read_int`, the
    read owner under an `overlay`), then packed in the canonical order
    within each shard: `partitioned_from_oracle`'s placement."""
    from types import SimpleNamespace

    from ..parallel.shard_utils import owner_read_int

    assert a_cap % n_shards == 0, (a_cap, n_shards)

    # Each id's owner once, then the objects bucketed by shard in their
    # own order.
    accounts = [{} for _ in range(n_shards)]
    for aid, a in sm.accounts.items():
        accounts[owner_read_int(aid, n_shards, overlay)][aid] = a
    by_ts = [{} for _ in range(n_shards)]
    for ts, tid in sm.transfer_by_timestamp.items():
        by_ts[owner_read_int(tid, n_shards, overlay)][ts] = tid

    packs = []
    for s in range(n_shards):
        view = SimpleNamespace(
            accounts=accounts[s],
            transfers=sm.transfers,
            transfer_by_timestamp=by_ts[s],
            pending_status=sm.pending_status,
            accounts_key_max=sm.accounts_key_max,
            transfers_key_max=sm.transfers_key_max,
            commit_timestamp=sm.commit_timestamp,
        )
        packs.append(pack_oracle_state(view, a_cap // n_shards))
    return packs


def partitioned_oracle_digest(sm, a_cap: int, n_shards: int,
                              overlay: tuple = ()) -> dict:
    """The expected digest of an oracle state under the partitioned
    layout: bit-comparable with `partitioned_state_digest` of a state
    stepped at the same (a_cap, n_shards) and overlay."""
    total: dict = {}
    for pack in pack_oracle_state_partitioned(sm, a_cap, n_shards,
                                              overlay):
        for k, v in _pack_digest(pack).items():
            total[k] = (total.get(k, 0) + v) & MASK64
    return total


# ------------------------------------------------------- range digests
# (live resharding, parallel/resharding.py.) The migration's flip needs a
# witness that one hash range is equal on the source and the target, whose
# rows sit at different row indices in the two stores: the range fold is
# position-independent. Each row mixes its own 64-bit ownership hash
# (`shard_utils.mix_id` over its id limbs) where the epoch fold mixes the
# row index. Rows outside the range are zeroed before the wrap-sum, so
# capacity, row order and neighbours cancel. The exclusions are the epoch
# digest's; each store's content fold is paired with its in-range row
# count.

_RSALT = {"accounts_u64": 0x5A1, "accounts_bal": 0x5B2,
          "transfers_u64": 0x5C3}


def _range_matrix_digest(m, count, col_masks, salt: int, h, member):
    """The position-independent fold over the rows < count that `member`
    (a bool vector: the migration's membership of each row's ownership
    hash `h`) selects. Returns (digest, rows) as 0-dim int64 tensors (u64
    bits)."""
    rows = m.shape[0]
    acc = torch.zeros(rows, dtype=torch.int64, device=m.device)
    for j in range(m.shape[1]):
        mask = MASK64 if col_masks is None else col_masks[j]
        if mask == 0:
            continue
        col = m[:, j]
        if mask != MASK64:
            col = col & s64(mask)
        acc = acc * _PHI + col
    rowd = _mix64(acc ^ (h * _PHI) ^ s64(salt))
    iota = torch.arange(rows, dtype=torch.int64, device=m.device)
    live = (iota < count) & member
    return (torch.sum(torch.where(live, rowd, 0)),
            live.sum().to(torch.int64))


def _range_digest_components(state: dict, lo: int, hi: int, src: int,
                             n_shards: int) -> dict:
    """The range fold over one shard's state, or a host pack's rows on CPU
    tensors. Membership is the overlay entry's predicate, `lo <= h <= hi`
    in u64 order and `base_owner(h) == src`, not the bare range: the flip
    compares the source with the target, and the target's own rows whose
    hashes fall in [lo, hi] must stay out of its fold. No scalars: row
    counts and key maxima are facts of a whole shard."""
    from ..parallel.shard_utils import _in_range, mix_id

    acc = state["accounts"]
    xfr = state["transfers"]

    def member(h):
        return _in_range(h, lo, hi) & ((h & (n_shards - 1)) == src)

    a_h = mix_id(acc["u64"][:, 0], acc["u64"][:, 1])
    x_h = mix_id(xfr["u64"][:, 0], xfr["u64"][:, 1])
    a_m, x_m = member(a_h), member(x_h)
    a_dig, a_n = _range_matrix_digest(acc["u64"], acc["count"], AC_COL_MASKS,
                                      _RSALT["accounts_u64"], a_h, a_m)
    b_dig, _ = _range_matrix_digest(acc["bal"], acc["count"], None,
                                    _RSALT["accounts_bal"], a_h, a_m)
    x_dig, x_n = _range_matrix_digest(xfr["u64"], xfr["count"],
                                      XF_COL_MASKS, _RSALT["transfers_u64"],
                                      x_h, x_m)
    return {"accounts_u64": a_dig, "accounts_bal": b_dig,
            "transfers_u64": x_dig, "accounts_rows": a_n,
            "transfers_rows": x_n}


def _resolved(comps: dict) -> dict:
    names = sorted(comps)
    vals = torch.stack([comps[k].to(torch.int64) for k in names])
    return {k: u64(v) for k, v in zip(names, vals.cpu().tolist())}


def partitioned_range_digest(state, lo: int, hi: int, src: int) -> list:
    """The range digests of a partitioned state (the tuple of per-shard
    dicts), one component dict a shard, not summed: the flip compares the
    source shard's with the target shard's (and with the oracle's) at one
    epoch. `src` is the range's base owner, the membership predicate's;
    the number of shards is the state's."""
    state = tuple(state)
    n = len(state)
    return [_resolved(_range_digest_components(sub, lo & MASK64, hi & MASK64,
                                               src, n))
            for sub in state]


def pack_range_digest(pack: dict, lo: int, hi: int, src: int,
                      n_shards: int) -> dict:
    """The range fold over a host pack of rows (`pack_oracle_state`'s
    shape: accounts and transfers with their counts), on CPU tensors."""
    return _resolved(_range_digest_components(
        _host_pack_state(pack), lo & MASK64, hi & MASK64, src, n_shards))


def oracle_range_digest(sm, a_cap: int, lo: int, hi: int, src: int,
                        n_shards: int) -> dict:
    """The expected range digest of an oracle state, over its canonical
    pack (the whole state: the fold is position-independent, so it equals
    the membership sum across any placement of the same rows)."""
    return pack_range_digest(pack_oracle_state(sm, a_cap), lo, hi, src,
                             n_shards)


def sum_range_components(comps: list) -> dict:
    """Wrap-sum a list of per-shard range-digest dicts (the source's and
    the target's during double-write, say)."""
    total: dict = {}
    for c in comps:
        for k, v in c.items():
            total[k] = (total.get(k, 0) + int(v)) & MASK64
    return total
