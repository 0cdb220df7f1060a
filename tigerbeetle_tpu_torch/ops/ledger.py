"""DeviceLedger: the device-resident account/transfer state store.

A port of the JAX package's `ops/ledger.py`: accounts and transfers live
on the card as packed int64-carried u64 row matrices (`init_state`);
id -> row lookups run through the device hash tables and the fused
probe kernel, row reads through the row-gather kernel; each batch runs
the vectorized kernels (`fast_kernels.py`) with no per-event host work.

create_transfers climbs the JAX package's escalation ladder: the plain
tier first; a fallback that only the fixpoint tiers resolve (`limit_only`)
reruns on the 8-round limit fixpoint tier, and one whose cascade is
deeper than 8 rounds (`fix_unconverged`) on the 32-round tier. After a
batch resolved on a fixpoint tier, later batches go to the fixpoint
tiers first until a batch shows no headroom breach; after a deep
escalation, the deep tier first for DEEP_PROBE_INTERVAL batches. A batch
with an imported flag climbs the imported ladder instead (the plain
imported tier, then the imported fixpoint tiers), and one with a
balancing flag the balancing ladder (8, then 32 rounds, with its own
deep-first regime); imported accounts run the imported accounts tier.

A batch that no device tier can run (a tier that falls back leaves the
state untouched) takes the exact host path, the host-mirror regime of
the JAX package: the first such batch builds a live host mirror of the
device state once (`to_host`, the port's own `StateMachineOracle`), the
batch runs on the oracle — the exact sequential semantics — and only the
objects it dirtied are scattered back to the device (`_push_dirty`, rows
appended in applied-timestamp order, as `from_host` packs them). While
the mirror is held every batch runs on it; after MIRROR_PROBE_INTERVAL
batches the next one probes the device tiers again, and the mirror is
dropped once a device tier takes a batch. Pending-transfer expiry
(`expire_pending_transfers`, when `pulse_needed`) always runs through
the mirror. No batch raises. Counters: `fallbacks` counts the batches
the mirror served, `fallback_causes` the device tiers' causes at each
final fallback.

Commit windows (`create_transfers_window`, and pipelined:
`submit_window` / `resolve_windows`) run W prepares in one device
dispatch: the chain route by default (one plain-tier run a prepare, a
fallback at prepare k committing [0, k) and replaying the rest), the flat
`super_imported` tier for imported windows (synchronous only, as in the
JAX package), `super_balancing` for balancing windows, `super_deep` for
windows with closing flags, in-window pending references or in the
limit-breach regime, and the flat `super` tier (with its escalation to
`super_deep`) for all-or-nothing windows. On the card each window is one
replay of a captured CUDA graph (`window_graph.py`); on the CPU the same
functions run eagerly.

One difference from the JAX package, deliberate: after an imported
batch or window the state's commit_ts is the last applied imported
timestamp, the oracle's value, where the JAX package's imported tiers
leave the prepare timestamp (see `fast_kernels.create_transfers_fast`).

Write-through mode (`DeviceLedger(write_through=sm)`, the serving path
under `StateMachine(engine="device")`): `sm`, a host oracle, is kept in
permanent lockstep with the device. A device batch or window gathers its
bounded delta on the card (the appended transfer and event rows, and the
touched accounts' ids and pending timestamps as one row-gather launch),
copies it into pinned host memory without waiting, and queues it as a
columnar chunk; `drain_mirror` registers the chunks in the lazy mirror
containers (`lazy_mirror.py`) at the next read. Hard batches run on the
mirror itself (no `to_host`) and push what they dirtied. Pipelined
windows gather on device-computed starts right after their dispatch;
`stage_window` packs the next window on a stager thread; with
`recycle_events` the event ring rewinds after every batch and window
(the ring window kernels on the pipelined route).

Supervision (the serving supervisor, `serving.py`, owns such a ledger):
`recovery_stats` holds the supervisor's counters and `fallback_stats()`
reports them beside the routing counters; `tracer` (a NullTracer unless
the supervisor installs its own) receives the window_stage spans and the
host_stall_fraction gauge of the pipelined route; with
`constants.VERIFY` on, every drain audits device rows against the
mirror through the device lookups (`_verify_mirror_spot`, raising
`MirrorDivergence`), `verify_spot_rate` rows of each chunk (0.0: two
rows of the newest chunk; >= 1.0: every row of every chunk); `release()`
gives a quarantined ledger's device memory back.

Durable flush columns (`retain_flush_columns`, which
`StateMachine.attach_durable` turns on): every queued chunk is also
retained, at capture, as a flush entry `(t, e, der, n_new,
events_seen_abs, orphan_ids)` that `take_flush_columns(count)` pops for
`vsr/durable.py`'s column flush, so flushing needs no drain. One entry a
batch that created rows or poisoned ids, and with all_or_nothing
windows one a prepare, empty ones too, so a replica attributes entries
to prepares by position.

The partitioned attach mode (`attach_partitioned(router, state)`):
windows commit on a partitioned mesh (`parallel/partitioned.py`) instead
of this ledger's state. `submit_window` runs the router's partitioned
chain (one captured CUDA graph a window on the card, key
("partitioned_chain", W, n_pad, overlay entries), the previous window's
poison copied device to device into its force_fallback);
`resolve_windows` lets the
router absorb a window's committed prefix and replays a redo through the
router's per-batch ladder (eager); the synchronous window path goes
through `PartitionedRouter.step_window`. The partitioned state is the
ledger then (`partitioned_state`); the single-chip state stays at its
attach-time snapshot. Write-through is single-chip scope and refused.

The device is explicit: `DeviceLedger(device=None)` means CUDA and
raises when no CUDA device is present; the tests pass `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import constants
from ..constants import BATCH_MAX, NS_PER_S, TIMESTAMP_MIN
from ..oracle.state_machine import AccountEventRecord, StateMachineOracle
from ..trace import Event, NullTracer
from ..types import (
    Account,
    AccountFlags,
    CreateAccountResult,
    CreateAccountStatus,
    CreateTransferResult,
    CreateTransferStatus,
    Transfer,
    TransferFlags,
    TransferPendingStatus,
)
from . import u128
from .batch import (
    accounts_to_arrays,
    transfers_from_arrays,
    transfers_to_arrays,
)
from .device import resolve_device
from .ev_layout import (
    AC_NCOLS,
    AC_P32_POS,
    AC_U64_IDX,
    EV_I32,
    EV_NCOLS,
    EV_P32_POS,
    EV_U64_IDX,
    XF_I32,
    XF_NCOLS,
    XF_P32_POS,
    XF_U64_IDX,
    ac_named,
    bal_col,
    ev_cap,
    ev_col,
    ev_named,
    pack32,
    xf_named,
)
from .fast_kernels import (
    create_accounts_fast,
    create_transfers_balancing,
    create_transfers_balancing_deep,
    create_transfers_chain,
    create_transfers_fast,
    create_transfers_fixpoint,
    create_transfers_fixpoint_deep,
    create_transfers_imported,
    create_transfers_imported_fixpoint,
    create_transfers_imported_fixpoint_deep,
    create_transfers_super,
    create_transfers_super_balancing,
    create_transfers_super_deep,
    create_transfers_super_imported,
)
from .fused_probe import ht_lookup_fused
from .hash_table import ORPHAN_VAL, SLOTS, ht_init, ht_insert
from .lazy_mirror import (
    DeltaChunk,
    LazyEventList,
    LazyTransferDict,
    apply_account_finals,
)
from .row_gather import row_gather_multi
from .u64 import carrier, s64, u64
from .window_graph import Harvest, WindowGraphs

N_PAD = 8192
assert N_PAD >= BATCH_MAX

# Padded-shape buckets for the kernels: a batch runs at the smallest
# bucket that fits.
PAD_BUCKETS = (1024, 2048, 4096, N_PAD)

_CTS_BY_CODE = {int(m): m for m in CreateTransferStatus}
_CAS_BY_CODE = {int(m): m for m in CreateAccountStatus}
_MASK64 = (1 << 64) - 1


class MirrorDivergence(AssertionError):
    """VERIFY spot-check failure: a device-resident row disagrees with
    the host mirror. Subclasses AssertionError (fail-loudly consumers keep
    working); the serving supervisor catches it specifically and routes to
    bounded replay recovery."""


def default_recovery_stats() -> dict:
    """The zero-valued recovery-counter record every ledger carries (the
    serving supervisor swaps in its live dict; see fallback_stats)."""
    return {"retries": 0, "backoff_s": 0.0, "replayed_windows": 0,
            "epochs_verified": 0, "checksum_mismatches": 0,
            "recoveries": {}}


def _pad_bucket(n: int) -> int:
    for b in PAD_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds BATCH_MAX padding")


def _split(x: int):
    return np.uint64(x >> 64), np.uint64(x & _MASK64)


def _limbs4(value: int):
    return [np.uint64((value >> (32 * j)) & 0xFFFFFFFF) for j in range(4)]


def _balance_int(acc, field, row) -> int:
    bal_row = acc["bal"][row]
    return sum(int(bal_row[bal_col(field, j)]) << (32 * j)
               for j in range(4))


def _set32(mat: np.ndarray, pos: dict, name: str, vals) -> None:
    """Write a 32-bit logical column into its packed u64 half (host
    writer counterpart of ev_layout's readers)."""
    col, half = pos[name]
    v = np.asarray(vals).astype(np.uint32).astype(np.uint64)
    mat[:, col] |= (v << np.uint64(32)) if half else v


def _u64_col(vals, n: int) -> np.ndarray:
    return np.fromiter(vals, dtype=np.uint64, count=n)


def _pack_transfer_rows(objs, pstat_of, acct_row_of, a_dump):
    """Transfer objects -> one packed uint64 row matrix, a column at a
    time (the epoch digests pack every transfer of an oracle)."""
    n = len(objs)
    u64m = np.zeros((n, XF_NCOLS), dtype=np.uint64)
    U = XF_U64_IDX
    for name, attr in (("id", "id"), ("dr", "debit_account_id"),
                       ("cr", "credit_account_id"), ("amt", "amount"),
                       ("pid", "pending_id"), ("ud128", "user_data_128")):
        vals = [getattr(o, attr) for o in objs]
        u64m[:, U[f"{name}_hi"]] = _u64_col((v >> 64 for v in vals), n)
        u64m[:, U[f"{name}_lo"]] = _u64_col((v & _MASK64 for v in vals), n)
    u64m[:, U["ud64"]] = _u64_col((o.user_data_64 for o in objs), n)
    u64m[:, U["ts"]] = _u64_col((o.timestamp for o in objs), n)
    u64m[:, U["expires"]] = _u64_col(
        (o.timestamp + o.timeout * NS_PER_S if o.timeout else 0
         for o in objs), n)
    w32 = {
        "ud32": (o.user_data_32 for o in objs),
        "timeout": (o.timeout for o in objs),
        "ledger": (o.ledger for o in objs),
        "code": (o.code for o in objs),
        "flags": (int(o.flags) for o in objs),
        "pstat": (pstat_of(o) for o in objs),
        "dr_row": (acct_row_of(o.debit_account_id, a_dump) for o in objs),
        "cr_row": (acct_row_of(o.credit_account_id, a_dump) for o in objs),
    }
    assert set(w32) == set(XF_P32_POS)
    for name, vals in w32.items():
        _set32(u64m, XF_P32_POS, name,
               np.fromiter(vals, dtype=np.int64, count=n))
    return u64m


def _pack_account_rows(objs):
    """Account objects -> (packed uint64 row matrix, balance-limb matrix)."""
    n = len(objs)
    u64m = np.zeros((n, AC_NCOLS), dtype=np.uint64)
    bal = np.zeros((n, 16), dtype=np.uint64)
    aw32 = {name: np.zeros(n, dtype=np.int64) for name in AC_P32_POS}
    AU = AC_U64_IDX
    for i, o in enumerate(objs):
        u64m[i, AU["id_hi"]], u64m[i, AU["id_lo"]] = _split(o.id)
        for f, val in (("dp", o.debits_pending), ("dpos", o.debits_posted),
                       ("cp", o.credits_pending),
                       ("cpos", o.credits_posted)):
            for j, lim in enumerate(_limbs4(val)):
                bal[i, bal_col(f, j)] = lim
        (u64m[i, AU["ud128_hi"]],
         u64m[i, AU["ud128_lo"]]) = _split(o.user_data_128)
        u64m[i, AU["ud64"]] = o.user_data_64
        u64m[i, AU["ts"]] = o.timestamp
        aw32["ud32"][i] = o.user_data_32
        aw32["ledger"][i] = o.ledger
        aw32["code"][i] = o.code
        aw32["flags"][i] = o.flags
    for name, vals in aw32.items():
        _set32(u64m, AC_P32_POS, name, vals)
    return u64m, bal


def _pack_event_rows(records, acct_row: dict, xfer_row: dict,
                     a_dump: int) -> dict:
    """Account-event records (the oracle's AccountEventRecord shape) ->
    the packed ring row matrix. A remote or missing account resolves to
    the dump row and a missing pending transfer to -1."""
    n = len(records)
    u64 = np.zeros((n, EV_NCOLS), dtype=np.uint64)
    w32 = {name: np.zeros(n, dtype=np.int64) for name in EV_P32_POS}
    U = EV_U64_IDX
    for i, rec in enumerate(records):
        u64[i, U["ts"]] = rec.timestamp
        u64[i, U["amt_hi"]], u64[i, U["amt_lo"]] = _split(rec.amount)
        u64[i, U["areq_hi"]], u64[i, U["areq_lo"]] = _split(
            rec.amount_requested)
        w32["tflags"][i] = (0xFFFFFFFF if rec.transfer_flags is None
                            else rec.transfer_flags)
        w32["pstat"][i] = int(rec.transfer_pending_status)
        w32["p_row"][i] = (
            xfer_row.get(rec.transfer_pending.id, -1)
            if rec.transfer_pending is not None else -1)
        for side, a in (("dr", rec.dr_account), ("cr", rec.cr_account)):
            w32[f"{side}_row"][i] = acct_row.get(a.id, a_dump)
            w32[f"{side}_flags"][i] = a.flags
            for f, val in (("dp", a.debits_pending),
                           ("dpos", a.debits_posted),
                           ("cp", a.credits_pending),
                           ("cpos", a.credits_posted)):
                (u64[i, U[f"{side}_{f}_hi"]],
                 u64[i, U[f"{side}_{f}_lo"]]) = _split(val)
    for name, vals in w32.items():
        _set32(u64, EV_P32_POS, name, vals)
    return {"u64": u64}


def init_state(a_cap: int = 1 << 17, t_cap: int = 1 << 21,
               orphan_cap: int | None = None, e_cap: int | None = None,
               device=None) -> dict:
    """A fresh ledger state: a dict of tensors on `device` (None: the
    card), laid out as the JAX package's `init_state` (u64 lanes as
    int64)."""
    device = resolve_device(device)
    if e_cap is None:
        e_cap = t_cap  # one history row per created transfer

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=device)

    def count():
        return torch.zeros((), dtype=torch.int32, device=device)

    ev_u64 = np.zeros((e_cap + 1, EV_NCOLS), dtype=np.uint64)
    _set32(ev_u64, EV_P32_POS, "p_row",
           np.full(e_cap + 1, -1, dtype=np.int64))
    _set32(ev_u64, EV_P32_POS, "tflags",
           np.full(e_cap + 1, 0xFFFFFFFF, dtype=np.int64))
    if orphan_cap is None:
        # Orphaned (transient-failure) ids are never evicted; keep the
        # table load low for failure-heavy workloads.
        orphan_cap = max(1 << 16, t_cap)
    # Orphans live inline in the transfer table (val = ORPHAN_VAL): size
    # it for both populations at <= 50% load.
    xfer_cap = 1 << (2 * t_cap + 2 * orphan_cap - 1).bit_length()
    return dict(
        accounts=dict(u64=zeros(a_cap + 1, AC_NCOLS),
                      bal=zeros(a_cap + 1, 16), count=count()),
        transfers=dict(u64=zeros(t_cap + 1, XF_NCOLS), count=count()),
        events=dict(u64=torch.from_numpy(ev_u64.view(np.int64)).to(device),
                    count=count()),
        acct_ht=ht_init(2 * a_cap, device),
        xfer_ht=ht_init(xfer_cap, device),
        acct_key_max=zeros(),
        xfer_key_max=zeros(),
        pulse_next=torch.ones((), dtype=torch.int64, device=device),
        commit_ts=zeros(),
    )


def pad_transfer_events(ev: dict, n_pad: int = N_PAD) -> dict:
    """Pad a transfers_to_arrays SoA dict to the kernel's static shape
    (host numpy) and add the `valid` lane mask."""
    n = len(ev["id_lo"])
    if n > n_pad:
        raise ValueError(f"batch of {n} exceeds the padded shape {n_pad}")
    out = {}
    for k, v in ev.items():
        arr = np.zeros(n_pad, dtype=v.dtype)
        arr[:n] = v
        out[k] = arr
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n] = True
    out["valid"] = valid
    return out


def pad_account_events(ev: dict, n_pad: int = N_PAD) -> dict:
    return pad_transfer_events(ev, n_pad)


def events_to_device(ev: dict, device) -> dict:
    """Padded host SoA events -> the kernels' tensors: u64 lanes as their
    int64 bit patterns, 32-bit lanes widened to int64, `valid` as bool."""
    return {k: carrier(v, device) for k, v in ev.items()}


def _host_bools(*flags) -> list:
    """Scalar device flags -> Python bools in one host sync."""
    return [bool(x) for x in torch.stack(flags).tolist()]


# ------------------------------------------------------------ commit windows

# The packed window: every event lane, then the seg lanes, as one int64
# lane matrix (bool lanes as 0/1; u64 as their int64 bit patterns).
_EV_LANES = tuple(transfers_to_arrays([])) + ("valid",)
_SEG_LANES = ("ts_event", "seg_start", "chain_term")
_LANES = _EV_LANES + _SEG_LANES
_BOOL_LANES = frozenset(("valid", "seg_start", "chain_term"))
_I_VALID, _I_TS, _I_START, _I_TERM = (
    _LANES.index(k) for k in ("valid",) + _SEG_LANES)


def fill_window(lanes: np.ndarray, evs: list[dict], timestamps: list[int],
                n_pad: int) -> None:
    """Write K unpadded prepares into `lanes`, an int64 (lanes, K, n_pad)
    array: the lane matrix of stack_chain_window's (ev, seg) and,
    flattened to (lanes, K·n_pad), of stack_superbatch's, in one pass
    over the inputs (the window routes write it straight into pinned host
    memory)."""
    assert len(evs) == len(timestamps) and evs
    local = np.arange(n_pad, dtype=np.uint64)
    for b, (e, ts) in enumerate(zip(evs, timestamps)):
        n = len(e["id_lo"])
        if n > n_pad:
            raise ValueError(f"batch of {n} exceeds the padded shape {n_pad}")
        row = lanes[:, b]
        row[:, n:] = 0
        for i, k in enumerate(_EV_LANES[:-1]):
            a = np.asarray(e[k])
            row[i, :n] = a.view(np.int64) if a.dtype == np.uint64 else a
        row[_I_VALID, :n] = 1
        row[_I_TS] = (np.uint64(ts) - np.uint64(n) + local
                      + np.uint64(1)).view(np.int64)
        row[[_I_START, _I_TERM], :n] = 0
        row[_I_START, 0] = 1
        if n:
            row[_I_TERM, n - 1] = 1


def unpack_window(lanes):
    """The lane matrix on the device -> (ev, seg) of carrier tensors."""
    out = {}
    for i, k in enumerate(_LANES):
        out[k] = lanes[i] != 0 if k in _BOOL_LANES else lanes[i]
    return ({k: out[k] for k in _EV_LANES},
            {k: out[k] for k in _SEG_LANES})


def stack_chain_window(evs: list[dict], timestamps: list[int],
                       n_pad: int = N_PAD):
    """K unpadded prepares -> (K, n_pad)-stacked inputs of
    create_transfers_chain, (ev, seg) in the JAX package's dtypes: row k
    is prepare k padded to n_pad, its lanes given the commit timestamps
    timestamps[k] - n_k + i + 1 (reference execute_create :3031), with
    the seg lanes of one prepare. The lanes are fill_window's."""
    lanes = np.empty((len(_LANES), len(evs), n_pad), dtype=np.int64)
    fill_window(lanes, evs, timestamps, n_pad)
    out = {}
    for k, v in zip(_LANES, lanes):
        if k in _BOOL_LANES:
            out[k] = v != 0
        elif k == "ts_event" or np.asarray(evs[0][k]).dtype == np.uint64:
            out[k] = v.view(np.uint64)
        else:
            out[k] = v.astype(np.asarray(evs[0][k]).dtype)
    return ({k: out[k] for k in _EV_LANES},
            {k: out[k] for k in _SEG_LANES})


def stack_superbatch(evs: list[dict], timestamps: list[int],
                     n_pad: int = N_PAD):
    """K unpadded prepares -> one flat superbatch: stack_chain_window's
    lanes concatenated to K·n_pad, (ev, seg) for create_transfers_super
    / _super_deep."""
    ev, seg = stack_chain_window(evs, timestamps, n_pad)
    return ({k: v.reshape(-1) for k, v in ev.items()},
            {k: v.reshape(-1) for k, v in seg.items()})


def _evs_pend_refs(evs: list[dict]) -> bool:
    """Does any pending id in the window match any id in it? (Over the
    unpadded prepares, the JAX package's pre-route.) True routes the
    window to the deep window tier, whose fixpoint resolves in-window
    references. Each u128 key is ranked in each of its halves over the
    window's keys, and the two ranks (each below 2^32) pack into one
    exact uint64 key, so the match is a 1-D set test (the JAX package's
    row-wise np.unique over (hi, lo) pairs gives the same answer, more
    slowly)."""
    pid_hi = np.concatenate([np.asarray(e["pid_hi"]) for e in evs])
    pid_lo = np.concatenate([np.asarray(e["pid_lo"]) for e in evs])
    nz = (pid_hi != 0) | (pid_lo != 0)
    if not nz.any():
        return False
    hi = np.concatenate([np.asarray(e["id_hi"]) for e in evs] + [pid_hi[nz]])
    lo = np.concatenate([np.asarray(e["id_lo"]) for e in evs] + [pid_lo[nz]])
    key = ((np.unique(hi, return_inverse=True)[1].astype(np.uint64) << 32)
           | np.unique(lo, return_inverse=True)[1].astype(np.uint64))
    n_ids = len(hi) - int(nz.sum())
    return bool(np.isin(key[n_ids:], key[:n_ids]).any())


def _has_flags(evs, bits: int) -> bool:
    bit = np.uint32(bits)
    return any((np.asarray(e["flags"]) & bit).any() for e in evs)


def _has_closing(evs) -> bool:
    return _has_flags(evs, TransferFlags.closing_debit
                      | TransferFlags.closing_credit)


def _has_balancing(evs) -> bool:
    return _has_flags(evs, TransferFlags.balancing_debit
                      | TransferFlags.balancing_credit)


def _has_imported(evs) -> bool:
    return _has_flags(evs, TransferFlags.imported)


_WINDOW_FNS = {
    "chain": create_transfers_chain,
    "super": create_transfers_super,
    "super_deep": create_transfers_super_deep,
    "super_imported": create_transfers_super_imported,
    "super_balancing": create_transfers_super_balancing,
}
# Outputs a window ticket keeps (the flat tiers add limit_only); a
# partitioned chain window's add the router's counters.
_WINDOW_OUTS = ("r_status", "r_ts", "fallback", "created_count",
                "fb_causes")
_PART_WINDOW_OUTS = _WINDOW_OUTS + ("cross_shard_transfers",
                                    "exchange_overflow", "shard_stats")


def _window_call(route: str, ring: bool = False):
    """The function a window route runs (and a CUDA graph captures):
    unpack the lane matrix and run the route's window kernel (its ring
    variant with `ring`), which updates the state in place; returns its
    outputs."""
    fn = _WINDOW_FNS[route]
    kw = {"ring_reset": True} if ring else {}

    def call(state, lanes, force_fallback):
        ev, seg = unpack_window(lanes)
        return fn(state, ev, seg, force_fallback, **kw)[1]

    return call


def _window_results(st, ts, ns, n_pad) -> list:
    """Flat (or stacked) window statuses and timestamps -> one (status
    uint32, timestamp uint64) pair a prepare."""
    st = st.reshape(-1)
    ts = ts.reshape(-1)
    return [(st[b * n_pad:b * n_pad + n].astype(np.uint32),
             ts[b * n_pad:b * n_pad + n].view(np.uint64).copy())
            for b, n in enumerate(ns)]


# ------------------------------------------------- write-through deltas

# Transient statuses poison the transfer id (reference:
# src/tigerbeetle.zig:320-399); the write-through delta mirrors the
# device's orphan inserts on the host with them.
_TRANSIENT_ARR = np.fromiter(
    (int(s) for s in CreateTransferStatus if s.transient()),
    dtype=np.uint32)
_CREATED = np.uint32(int(CreateTransferStatus.created))
_F_PENDING = int(TransferFlags.pending)
# Windows free of these flags fetch half the delta (the event rows): the
# transfer rows are a function of the inputs, statuses and timestamps
# (`_synth_t_cols`).
_F_NOT_SYNTH = np.uint32(int(
    TransferFlags.post_pending_transfer | TransferFlags.void_pending_transfer
    | TransferFlags.imported | TransferFlags.balancing_debit
    | TransferFlags.balancing_credit))
# Delta gather sizes (rows): point batches, one prepare, a window of 8.
_DELTA_BUCKETS = (256, N_PAD, 8 * N_PAD)
_DER_KEYS = ("dr_id_hi", "dr_id_lo", "cr_id_hi", "cr_id_lo", "p_ts")
_HOST_LAYOUT = {"t": (xf_named, XF_U64_IDX, frozenset(XF_I32)),
                "e": (ev_named, EV_U64_IDX, frozenset(EV_I32))}

# The write-through deltas' row-gather launches (one a full delta
# gather) and the bytes they copied device to host: chip_smoke.py reads
# them a batch and a window.
DELTA_GATHERS = 0
D2H_BYTES = 0


def _host_named(which: str, mat: np.ndarray) -> dict:
    """An int64-carried row matrix on the host -> named columns in the
    JAX package's host dtypes (u64 lanes as uint64, 32-bit lanes as
    uint32 / int32): the one place the delta leaves the carrier."""
    named, u64s, signed = _HOST_LAYOUT[which]
    out = {}
    for k, v in named({"u64": mat}).items():
        out[k] = (v.view(np.uint64) if k in u64s
                  else v.astype(np.int32 if k in signed else np.uint32))
    return out


def _rows(mat, start, size: int):
    """Rows [start, start + size) of a row matrix as a new tensor. A host
    int start slices; a device start (a pipelined window's, computed on
    the card) selects arange + start, so nothing crosses to the host and
    the window needs no sync."""
    if isinstance(start, int):
        return mat[start:start + size].clone()
    idx = torch.arange(size, dtype=torch.int64, device=mat.device) + start
    return mat.index_select(0, idx)


def _delta_gather_body(state, t_start, e_start, size_t: int, size_e: int):
    """The device side of one write-through delta: fixed-size slices of
    the appended transfer and event rows, and the derived gathers — the
    touched accounts' ids and the pending transfers' timestamps — as ONE
    row-gather launch of two tables (account rows at the events' dr/cr
    rows, transfer rows at their p_rows)."""
    global DELTA_GATHERS
    acc, xfr, evr = state["accounts"], state["transfers"], state["events"]
    t = _rows(xfr["u64"], t_start, size_t)
    e = _rows(evr["u64"], e_start, size_e)
    er = {"u64": e}
    assert (AC_U64_IDX["id_hi"], AC_U64_IDX["id_lo"]) == (0, 1)
    ids, p = row_gather_multi(
        (acc["u64"], xfr["u64"]),
        (torch.cat([ev_col(er, "dr_row"), ev_col(er, "cr_row")]),
         torch.clamp(ev_col(er, "p_row"), min=0)))
    DELTA_GATHERS += 1
    der = torch.stack([ids[:size_e, 0], ids[:size_e, 1], ids[size_e:, 0],
                       ids[size_e:, 1], p[:, XF_U64_IDX["ts"]]], dim=1)
    return {"t": t, "e": e, "der": der}


def _window_start(store: dict, created, size: int, length: int):
    """A window's delta slice start on the device: its rows are the
    store's last `created` ones, clamped as `_delta_fetch_start` clamps."""
    return torch.clamp(store["count"].to(torch.int64)
                       - created.to(torch.int64), 0, length - size)


def _xfer_delta_gather_window(state, created, size_t: int, size_e: int):
    """A pipelined window's delta gather, its starts computed on the card
    from the post-window counts; the resolver recomputes the same
    offsets from the host counters."""
    xfr, evr = state["transfers"], state["events"]
    return _delta_gather_body(
        state, _window_start(xfr, created, size_t, xfr["u64"].shape[0]),
        _window_start(evr, created, size_e, ev_cap(evr) + 1),
        size_t, size_e)


def _ev_delta_gather_window(state, created, size_e: int):
    """The half-width window gather: the event rows only (the per-event
    balance snapshots); the transfer rows and touched ids of a window
    with no post/void, imported or balancing flag synthesize on the host
    (`_synth_t_cols` / `_synth_der_cols`)."""
    evr = state["events"]
    return _ev_delta_gather_host(
        state, _window_start(evr, created, size_e, ev_cap(evr) + 1), size_e)


def _ev_delta_gather_host(state, e_start, size_e: int):
    return {"e": _rows(state["events"]["u64"], e_start, size_e)}


class _DeltaFetchHandle:
    """One delta gather in flight. Its device rows are copied into pinned
    host buffers by non-blocking copies with an event behind them
    (`window_graph.Harvest`): at construction, or with eager_copy=False
    (the pipelined windows) at `start_copy`, which the drain calls, so
    the copy stays off the commit path. `_resolve` waits for the event
    before any host view is read; `slice_cols` returns exact-size copies,
    so the pinned buffers go back to PyTorch's caching host allocator
    once every chunk over them has loaded (at most 32 unloaded,
    `DeviceLedger._track_pending_cols`)."""

    __slots__ = ("_dev", "_harvest", "_host", "t0", "_t_off", "_e_off")

    def __init__(self, dev_out, t0, t_off, e_off, eager_copy=True):
        self._dev = dev_out
        self._harvest = None
        self._host = None
        self.t0 = t0
        self._t_off = t_off
        self._e_off = e_off
        if eager_copy:
            self.start_copy()

    def start_copy(self) -> None:
        """Start the device-to-host copies (idempotent)."""
        global D2H_BYTES
        if self._harvest is None and self._host is None:
            dev, self._dev = self._dev, None
            D2H_BYTES += sum(v.numel() * v.element_size()
                             for v in dev.values())
            self._harvest = Harvest(dev, tuple(dev))

    def _resolve(self) -> dict:
        host = self._host
        if host is None:
            self.start_copy()
            raw, self._harvest = self._harvest.get(), None
            host = self._host = {k: _host_named(k, raw[k])
                                 for k in ("t", "e") if k in raw}
            if "der" in raw:
                der = raw["der"].view(np.uint64)
                host["der"] = {k: der[:, i] for i, k in enumerate(_DER_KEYS)}
        return host

    def slice_cols(self, which: str, rel: int, n: int) -> dict:
        cols = self._resolve()[which]
        o = (self._t_off if which == "t" else self._e_off) + rel
        return {k: v[o:o + n].copy() for k, v in cols.items()}


class _ColsView:
    """Lazily loaded named columns: the one mapping surface the drain and
    the lazy mirror read, for device-fetched and host-synthesized
    chunks alike."""

    __slots__ = ("_d",)

    def _load(self) -> dict:
        raise NotImplementedError

    def load(self) -> dict:
        d = self._d
        if d is None:
            d = self._d = self._load()
        return d

    @property
    def loaded(self) -> bool:
        return self._d is not None

    def __getitem__(self, key):
        return self.load()[key]

    def __contains__(self, key):
        return key in self.load()

    def keys(self):
        return self.load().keys()

    def values(self):
        return self.load().values()

    def items(self):
        return self.load().items()

    def __iter__(self):
        return iter(self.load())

    def __len__(self):
        return len(self.load())


class _LazyCols(_ColsView):
    """Columns over a _DeltaFetchHandle slice (device-fetched)."""

    __slots__ = ("_handle", "_which", "_rel", "_n")

    def __init__(self, handle, which, rel, n):
        self._handle = handle
        self._which = which
        self._rel = rel
        self._n = n
        self._d = None

    def _load(self) -> dict:
        d = self._handle.slice_cols(self._which, self._rel, self._n)
        self._handle = None
        return d


def _synth_t_cols(ev: dict, st_np, ts_b: int) -> dict:
    """The created transfer rows' named columns rebuilt from the batch's
    inputs (batches with no post/void, imported or balancing flag:
    amounts are literal and nothing inherits from a pending). Equal bit
    for bit to the rows the device tier writes (expires = ts + timeout
    for a pending with a timeout, pstat pending or none)."""
    n_b = len(st_np)
    idx = np.nonzero(np.asarray(st_np) == _CREATED)[0]

    def col(name):
        return np.asarray(ev[name])[idx]

    ts_event = (np.uint64(ts_b) - np.uint64(n_b)
                + idx.astype(np.uint64) + np.uint64(1))
    flags = col("flags")
    pending = (flags & np.uint32(_F_PENDING)) != 0
    timeout = col("timeout")
    expires = np.where(
        pending & (timeout != 0),
        ts_event + timeout.astype(np.uint64) * np.uint64(NS_PER_S),
        np.uint64(0))
    cols = {n: col(n) for n in
            ("id_hi", "id_lo", "dr_hi", "dr_lo", "cr_hi", "cr_lo",
             "amt_hi", "amt_lo", "pid_hi", "pid_lo", "ud128_hi",
             "ud128_lo", "ud64", "ud32", "timeout", "ledger", "code",
             "flags")}
    cols["ts"] = ts_event
    cols["expires"] = expires
    cols["pstat"] = np.where(
        pending, np.int32(int(TransferPendingStatus.pending)),
        np.int32(int(TransferPendingStatus.none)))
    zrow = np.zeros(len(idx), np.int32)  # device-internal row indices
    cols["dr_row"] = zrow
    cols["cr_row"] = zrow
    return cols


def _synth_der_cols(ev: dict, st_np) -> dict:
    """The derived columns of such a batch: the touched accounts' ids are
    the inputs' debit/credit ids; p_ts is unused (no posts or voids)."""
    idx = np.nonzero(np.asarray(st_np) == _CREATED)[0]
    return {
        "dr_id_hi": np.asarray(ev["dr_hi"])[idx],
        "dr_id_lo": np.asarray(ev["dr_lo"])[idx],
        "cr_id_hi": np.asarray(ev["cr_hi"])[idx],
        "cr_id_lo": np.asarray(ev["cr_lo"])[idx],
        "p_ts": np.zeros(len(idx), np.uint64),
    }


class _SynthCols(_ColsView):
    """Host-synthesized named columns: _LazyCols' surface with no device
    buffer behind it."""

    __slots__ = ("_builder", "_args")

    def __init__(self, builder, *args):
        self._builder = builder
        self._args = args
        self._d = None

    def _load(self) -> dict:
        d = self._builder(*self._args)
        self._builder = self._args = None
        return d


def _batch_delta_stats(ev: dict, st_np):
    """(created count, orphan ids) of one batch's statuses: the
    per-prepare summary both capture paths queue from."""
    orph_mask = np.isin(st_np, _TRANSIENT_ARR)
    orphan_ids = ([(int(ev["id_hi"][i]) << 64) | int(ev["id_lo"][i])
                   for i in np.nonzero(orph_mask)[0]]
                  if orph_mask.any() else [])
    return int((st_np == _CREATED).sum()), orphan_ids


def _delta_bucket(n_new: int) -> int:
    for size in _DELTA_BUCKETS:
        if n_new <= size:
            return size
    return size


class WindowTicket:
    """One pipelined window in flight: dispatched, its outputs being
    copied to the host, nothing synced. resolve_windows() recovers, in
    submission order, exactly the synchronous path's results, or replays
    the poisoned suffix after a fallback (a poisoned window left the
    state untouched)."""

    __slots__ = ("evs", "tss", "ns", "n_pad", "route", "deep", "poison",
                 "outs", "harvest", "results", "gather", "size", "e_only")

    def __init__(self, evs, tss, ns, n_pad, route, deep, poison, outs,
                 gather=None, size=(0, 0), e_only=False):
        self.evs = evs
        self.tss = tss
        self.ns = ns
        self.n_pad = n_pad
        # "chain" or "partitioned_chain" (per-prepare outputs), or a flat
        # tier's (window-wide).
        self.route = route
        self.deep = deep
        # The device flag the next in-flight window takes as
        # force_fallback: the chain's last prepare's fallback (poisoning
        # is transitive, so it is "any prepare fell back"), the flat
        # tier's window flag.
        self.poison = poison
        self.outs = outs
        self.harvest = None
        self.results = None  # ("ok" | "redo", [(status, ts), ...])
        # Write-through: the window's delta gather (issued right after
        # the dispatch, on the device's counts), its (size_t, size_e),
        # and whether it is the half-width event-only one.
        self.gather = gather
        self.size = size
        self.e_only = e_only

    def start_harvest(self) -> None:
        """Start the non-blocking copies of the ticket's outputs into
        pinned host buffers (idempotent). submit_window calls it right
        after the dispatch: on the card the outputs are a graph's, and the
        next replay of that graph overwrites them, so they are copied out
        in stream order before it."""
        if self.harvest is None:
            self.harvest = Harvest(self.outs, (
                _PART_WINDOW_OUTS if self.route == "partitioned_chain"
                else _WINDOW_OUTS))
            self.outs = None


class DeviceLedger:
    """The device ledger state plus the batch entry points."""

    # After this many consecutive batches in the host-mirror regime, the
    # next one probes the device tiers again (hysteresis).
    MIRROR_PROBE_INTERVAL = 8
    # After an 8 -> 32-round escalation, dispatch the deep tier directly
    # for this many breach batches before re-probing the shallow one.
    DEEP_PROBE_INTERVAL = 8

    def __init__(self, a_cap: int = 1 << 17, t_cap: int = 1 << 21,
                 write_through=None, device=None):
        self.device = resolve_device(device)
        self.a_cap = a_cap
        self.t_cap = t_cap
        self.state = init_state(a_cap, t_cap, device=self.device)
        # The event ring's host cursor (its device row count).
        self._events_pushed = 0
        # Serving with history kept elsewhere: the ring's consumed rows
        # are recycled after every batch and window (the ring is a
        # per-batch transport), and pipelined windows take the ring
        # window kernels, which consume it from row 0.
        self.recycle_events = False
        self.fast_batches = 0
        self.fixpoint_batches = 0
        self.deep_fixpoint_batches = 0
        # On-device tier redispatches (plain -> fixpoint, shallow ->
        # deep): resolved without the host.
        self.escalations = 0
        self.fallbacks = 0
        self._deep_first = 0
        # The balancing tiers' own deep-first regime (after a balancing
        # batch escalated to 32 rounds).
        self._bal_deep_first = 0
        # Adaptive routing: after a batch resolved breaches on a fixpoint
        # tier, later batches dispatch the fixpoint tiers first (skipping
        # the headroom proof that would fail anyway) until a breach-free
        # batch cools the workload back down.
        self._fixpoint_first = False
        # Per-cause counts of the device tiers' fallback flags, taken at
        # every final fallback decision (escalations resolved on a deeper
        # tier never reach it).
        self.fallback_causes: dict = {}
        # The host-mirror regime: a live oracle mirror of the device
        # state (`mirror`, set below), reused across consecutive hard
        # batches, so each costs an oracle apply and a push of what it
        # dirtied instead of a full state sync both ways.
        self._mirror_batches = 0
        self._probe_pending = False
        # id -> device row of the mirror's objects (set by to_host /
        # from_host, extended by _push_dirty), and the absolute count of
        # the mirror's history rows already on the device.
        self._acct_row: dict[int, int] = {}
        self._xfer_row: dict[int, int] = {}
        self._events_seen_abs = 0
        # Commit windows: windows per route, the per-cause prepares that
        # fell out of a chain window, the last route and its latency
        # class, windows that fell back; the pipelined windows in flight;
        # the window graphs (on the card) and their counters.
        self.window_routes: dict = {}
        self.chain_batch_fallbacks: dict = {}
        self.last_window_route: str | None = None
        self.last_window_tier: str | None = None
        self.window_fallbacks = 0
        self._tickets: list[WindowTicket] = []
        self.windows = WindowGraphs(self.device)
        # Window staging: a one-worker stager packs the NEXT window into
        # pinned host memory while the current one runs; submit_window
        # consumes a staged pack of exactly its window, else packs
        # inline (the same bytes). overlap_staging=False packs inline
        # always. staging_stats: windows through submit_window, staged
        # packs consumed, misses, and the host time the dispatch path
        # waited on the pack (stall_ms) against the pack work wherever
        # it ran (work_ms).
        self.overlap_staging = True
        self._staged = None
        self._stager = None
        self.staging_stats = {"windows": 0, "staged": 0, "misses": 0,
                              "stall_ms": 0.0, "work_ms": 0.0}
        # The partitioned attach mode: the router windows commit through
        # and its state (`attach_partitioned`).
        self._part_router = None
        self._part_state = None
        # Supervision: the serving supervisor installs its live counter
        # dict and its tracer here; a standalone ledger keeps zeros and
        # the null tracer. verify_spot_rate: the VERIFY drain audit's
        # sampling (0.0: two rows of the newest chunk; >= 1.0: every row
        # of every chunk).
        self.recovery_stats: dict = default_recovery_stats()
        self.tracer = NullTracer()
        self.verify_spot_rate = 0.0
        # Write-through mode (the serving path): `write_through` is a host
        # oracle kept in permanent lockstep with the device. Device
        # batches queue their bounded device-to-host delta as columnar
        # chunks (`_mirror_chunks`), which `drain_mirror` materializes
        # into it at the next read; hard batches run on it directly and
        # push what they dirtied back down. The mirror is never dropped.
        self.mirror = write_through
        self._wt = write_through is not None
        self._op_seq = 0
        self._mirror_chunks: list = []
        # The durable flusher's entries (retain_flush_columns), in op
        # order, popped by take_flush_columns.
        self.retain_flush_columns = False
        self._flush_columns: list = []
        # Unloaded delta columns still holding device rows (at most 32).
        self._pending_cols: list = []
        # Device transfer rows, queued chunks included (len(_xfer_row)
        # lags it until the next drain).
        self._xfer_rows_dev = 0
        if self._wt:
            self._enable_dev_tracking(write_through)
            self._hard_regime = False
            if (write_through.accounts or write_through.transfers
                    or write_through.account_events):
                # A restored state: rebuild the device tables from it.
                self.from_host(write_through)

    # ------------------------------------------------------------- fast path

    def create_accounts(self, accounts: list[Account], timestamp: int):
        self.resolve_windows()  # pipeline ordering
        if self._mirror_route():
            self.fallbacks += 1
            self.drain_mirror()
            results = self.mirror.create_accounts(accounts, timestamp)
            self._push_dirty()
            return results
        n = len(accounts)
        ev = pad_account_events(accounts_to_arrays(accounts),
                                n_pad=_pad_bucket(n))
        # Imported accounts run the imported accounts tier.
        imported = bool((np.asarray(ev["flags"])
                         & np.uint32(AccountFlags.imported)).any())
        self.state, out = create_accounts_fast(
            self.state, events_to_device(ev, self.device), timestamp, n,
            imported_mode=imported)
        if bool(out["fallback"]):
            # The state is unchanged: the batch runs on the mirror.
            return self._fallback_accounts(accounts, timestamp)
        self.fast_batches += 1
        self._probe_succeeded()
        st = out["r_status"][:n].cpu().numpy().astype(np.uint32)
        ts = out["r_ts"][:n].cpu().numpy().view(np.uint64)
        if self._wt:
            self._apply_fast_delta_accounts(st)
        st_l = st.tolist()
        ts_l = ts.tolist()
        return [CreateAccountResult(timestamp=ts_l[i],
                                    status=_CAS_BY_CODE[st_l[i]])
                for i in range(n)]

    def create_transfers(self, transfers: list[Transfer], timestamp: int):
        ev = transfers_to_arrays(transfers)
        return self.create_transfers_arrays(ev, timestamp,
                                            transfers=transfers)

    def create_transfers_soa(self, ev: dict, timestamp: int):
        """SoA events in, (status uint32, timestamp uint64) numpy arrays
        out — no per-event Python."""
        return self.create_transfers_arrays(ev, timestamp, raw=True)

    def _escalate_fixpoint(self, evd, timestamp, n, balancing=False,
                           imported=False):
        """The 8-round tier reported a cascade deeper than its budget (and
        no other obstacle): rerun on the 32-round tier of the same kind
        and enter its deep-first regime (balancing keeps its own counter;
        the imported tiers have none). Returns (fallback, out) of the
        deep run."""
        deep = (create_transfers_balancing_deep if balancing
                else create_transfers_imported_fixpoint_deep if imported
                else create_transfers_fixpoint_deep)
        self.state, out = deep(self.state, evd, timestamp, n)
        self.deep_fixpoint_batches += 1
        self.escalations += 1
        if balancing:
            self._bal_deep_first = self.DEEP_PROBE_INTERVAL
        elif not imported:
            self._deep_first = self.DEEP_PROBE_INTERVAL
        return bool(out["fallback"]), out

    def create_transfers_arrays(self, ev: dict, timestamp: int,
                                transfers=None, raw: bool = False):
        """ev: unpadded host SoA dict (`transfers`: the same events as
        objects, when the caller has them). The tier ladder reads its
        flags with one host sync per tier run (the JAX package's
        device_gets); the results then come back in one copy each. A tier
        that falls back left the state and the events untouched, so the
        next tier reruns the same batch, and the mirror the batch the
        last tier gave up. With raw=True the results are (status uint32,
        timestamp uint64) arrays on every route."""
        self.resolve_windows()  # pipeline ordering
        if self._mirror_route():
            self.fallbacks += 1
            if transfers is None:
                transfers = transfers_from_arrays(ev)
            self.drain_mirror()
            results = self.mirror.create_transfers(transfers, timestamp)
            self._push_dirty()
            return results_to_arrays(results) if raw else results
        n = len(ev["id_lo"])
        evd = events_to_device(
            pad_transfer_events(ev, n_pad=_pad_bucket(n)), self.device)
        if _has_imported([ev]):
            # The imported tier; closing flags, voids of closing pendings
            # and potential limit breaches escalate to the imported
            # fixpoint tiers, chains and collisions go to the exact path.
            self.state, out = create_transfers_imported(
                self.state, evd, timestamp, n)
            fallback, limit_only = _host_bools(out["fallback"],
                                               out["limit_only"])
            if fallback and limit_only:
                self.escalations += 1
                self.state, out = create_transfers_imported_fixpoint(
                    self.state, evd, timestamp, n)
                fallback, unconverged = _host_bools(out["fallback"],
                                                    out["fix_unconverged"])
                if fallback and unconverged:
                    fallback, out = self._escalate_fixpoint(
                        evd, timestamp, n, imported=True)
                if not fallback:
                    self.fixpoint_batches += 1
        elif _has_balancing([ev]):
            # Balancing clamps ride the fixpoint: straight to the
            # balancing tier, with the shallow -> deep ladder and its own
            # deep-first regime.
            if self._bal_deep_first > 0:
                self._bal_deep_first -= 1
                self.state, out = create_transfers_balancing_deep(
                    self.state, evd, timestamp, n)
                self.deep_fixpoint_batches += 1
                fallback = bool(out["fallback"])
            else:
                self.state, out = create_transfers_balancing(
                    self.state, evd, timestamp, n)
                fallback, unconverged = _host_bools(out["fallback"],
                                                    out["fix_unconverged"])
                if fallback and unconverged:
                    fallback, out = self._escalate_fixpoint(
                        evd, timestamp, n, balancing=True)
            if not fallback:
                self.fixpoint_batches += 1
        elif self._fixpoint_first:
            # The workload has been breaching balance limits: go straight
            # to the fixpoint tiers, and to the deep one while cascades
            # have been exceeding the shallow budget (re-probing the
            # shallow one every DEEP_PROBE_INTERVAL batches).
            if self._deep_first > 0:
                self._deep_first -= 1
                self.state, out = create_transfers_fixpoint_deep(
                    self.state, evd, timestamp, n)
                self.deep_fixpoint_batches += 1
                fallback, limit_hit = _host_bools(out["fallback"],
                                                  out["limit_hit"])
            else:
                self.state, out = create_transfers_fixpoint(
                    self.state, evd, timestamp, n)
                fallback, limit_hit, unconverged = _host_bools(
                    out["fallback"], out["limit_hit"],
                    out["fix_unconverged"])
                if fallback and unconverged:
                    fallback, out = self._escalate_fixpoint(
                        evd, timestamp, n)
            if not fallback:
                self.fixpoint_batches += 1
                if not limit_hit:
                    self._fixpoint_first = False
        else:
            self.state, out = create_transfers_fast(
                self.state, evd, timestamp, n)
            fallback, limit_only = _host_bools(out["fallback"],
                                               out["limit_only"])
            if fallback and limit_only:
                # The only obstacles were the headroom proof, a collision,
                # a closing flag or a void of a closing pending: all
                # resolve natively on the fixpoint tier.
                self.escalations += 1
                self.state, out = create_transfers_fixpoint(
                    self.state, evd, timestamp, n)
                fallback, unconverged = _host_bools(out["fallback"],
                                                    out["fix_unconverged"])
                if fallback and unconverged:
                    fallback, out = self._escalate_fixpoint(
                        evd, timestamp, n)
                if not fallback:
                    self.fixpoint_batches += 1
                    self._fixpoint_first = True
        if fallback:
            self._note_fb(out)
            if transfers is None:
                transfers = transfers_from_arrays(ev)
            results = self._fallback_transfers(transfers, timestamp)
            return results_to_arrays(results) if raw else results
        self.fast_batches += 1
        self._probe_succeeded()
        st = out["r_status"][:n].cpu().numpy().astype(np.uint32)
        ts = out["r_ts"][:n].cpu().numpy().view(np.uint64)
        if self._wt:
            self._capture_fast_delta_transfers(ev, st)
        if raw:
            return st, ts
        st_l = st.tolist()
        ts_l = ts.tolist()
        return [CreateTransferResult(timestamp=ts_l[i],
                                     status=_CTS_BY_CODE[st_l[i]])
                for i in range(n)]

    # ------------------------------------------------------------- lookups

    def _gather_rows(self, table_key: str, store: dict, ids: list[int]):
        """Device-side id->row probe + one row gather launch for all the
        store's matrices: only the queried rows cross to the host."""
        self.resolve_windows()  # pipeline ordering
        hi, lo = u128.from_ints(ids)
        found, rows = ht_lookup_fused(
            self.state[table_key],
            torch.from_numpy(hi).to(self.device),
            torch.from_numpy(lo).to(self.device))
        # Orphan markers (negative vals) are not live objects.
        found = found & (rows >= 0)
        rows = torch.clamp(rows, min=0).to(torch.int64)
        keys = [k for k in store if k != "count"]
        outs = row_gather_multi([store[k] for k in keys], rows)
        gathered = {k: out.cpu() for k, out in zip(keys, outs)}
        return found.cpu().numpy(), gathered

    def lookup_accounts(self, ids: list[int]) -> list[Account]:
        found, g = self._gather_rows("acct_ht", self.state["accounts"], ids)
        acc = {k: v.numpy() for k, v in ac_named(g).items()}
        out = []
        for i, aid in enumerate(ids):
            if not found[i]:
                continue

            def bal(field):
                return sum((int(acc["bal"][i, bal_col(field, j)])
                            & 0xFFFFFFFF) << (32 * j) for j in range(4))

            out.append(Account(
                id=aid,
                debits_pending=bal("dp"),
                debits_posted=bal("dpos"),
                credits_pending=bal("cp"),
                credits_posted=bal("cpos"),
                user_data_128=u128.to_int(acc["ud128_hi"][i],
                                          acc["ud128_lo"][i]),
                user_data_64=int(acc["ud64"][i]) & _MASK64,
                user_data_32=int(acc["ud32"][i]),
                ledger=int(acc["ledger"][i]),
                code=int(acc["code"][i]),
                flags=int(acc["flags"][i]),
                timestamp=int(acc["ts"][i]) & _MASK64,
            ))
        return out

    def lookup_transfers(self, ids: list[int]) -> list[Transfer]:
        found, g = self._gather_rows("xfer_ht", self.state["transfers"],
                                     ids)
        x = {k: v.numpy() for k, v in xf_named(g).items()}
        return [_transfer_from_row(x, i, ids[i])
                for i in range(len(ids)) if found[i]]

    # --------------------------------------------------- host mirror

    def to_host(self) -> StateMachineOracle:
        """An oracle state rebuilt from the device state. Each matrix is
        sliced to its live rows on the device before it crosses to the
        host. Also records the id -> device row maps the mirror regime
        pushes its deltas by."""
        self.resolve_windows()  # pipeline ordering
        if self._wt:
            self.drain_mirror()
        self._acct_row = {}
        self._xfer_row = {}
        sm = StateMachineOracle()
        st = self.state
        n_a = int(st["accounts"]["count"])
        acc = ac_named({k: st["accounts"][k][:n_a].cpu().numpy()
                        for k in ("u64", "bal")})
        for r in range(n_a):
            a = Account(
                id=u128.to_int(acc["id_hi"][r], acc["id_lo"][r]),
                debits_pending=_balance_int(acc, "dp", r),
                debits_posted=_balance_int(acc, "dpos", r),
                credits_pending=_balance_int(acc, "cp", r),
                credits_posted=_balance_int(acc, "cpos", r),
                user_data_128=u128.to_int(acc["ud128_hi"][r],
                                          acc["ud128_lo"][r]),
                user_data_64=u64(acc["ud64"][r]),
                user_data_32=int(acc["ud32"][r]),
                ledger=int(acc["ledger"][r]),
                code=int(acc["code"][r]),
                flags=int(acc["flags"][r]),
                timestamp=u64(acc["ts"][r]),
            )
            sm.accounts[a.id] = a
            sm.account_by_timestamp[a.timestamp] = a.id
            self._acct_row[a.id] = r

        n_t = int(st["transfers"]["count"])
        xfr = xf_named({"u64": st["transfers"]["u64"][:n_t].cpu().numpy()})
        for r in range(n_t):
            t = _transfer_from_row(xfr, r, None)
            sm.transfers[t.id] = t
            sm.transfer_by_timestamp[t.timestamp] = t.id
            self._xfer_row[t.id] = r
            pstat = int(xfr["pstat"][r])
            if pstat != 0:
                sm.pending_status[t.timestamp] = TransferPendingStatus(pstat)
                if (pstat == int(TransferPendingStatus.pending)
                        and t.timeout != 0):
                    sm.expiry[t.timestamp] = (t.timestamp
                                              + t.timeout * NS_PER_S)

        # Orphaned ids: the live slots of the transfer table holding the
        # orphan sentinel, picked out on the device (the table at the
        # default capacities is ~201 MB; only the orphans cross).
        packed = st["xfer_ht"]["packed"][:-1]
        k_hi, k_lo = packed[:, :SLOTS], packed[:, SLOTS:2 * SLOTS]
        orphan = (packed[:, 2 * SLOTS:] < 0) & ((k_hi != 0) | (k_lo != 0))
        for hi_k, lo_k in zip(k_hi[orphan].tolist(), k_lo[orphan].tolist()):
            sm.orphaned.add(u128.to_int(hi_k, lo_k))

        sm.accounts_key_max = u64(st["acct_key_max"]) or None
        sm.transfers_key_max = u64(st["xfer_key_max"]) or None
        sm.pulse_next_timestamp = u64(st["pulse_next"])
        sm.commit_timestamp = u64(st["commit_ts"])
        if self._wt and self.recycle_events:
            # The ring is recycled after every batch: the write-through
            # mirror holds the history.
            sm.account_events = list(self.mirror.account_events)
            sm.events_base = self.mirror.events_base
        else:
            sm.account_events = self._events_to_host(acc, xfr)
            self._events_pushed = len(sm.account_events)
            self._events_seen_abs = sm.events_base + len(sm.account_events)
        self._xfer_rows_dev = len(self._xfer_row)
        return sm

    def _events_to_host(self, acc, xfr) -> list:
        """AccountEventRecords rebuilt from the device history ring (the
        account_events groove rows), its live rows only."""
        evs = self.state["events"]
        n_e = int(evs["count"])
        evr = ev_named({"u64": evs["u64"][:n_e].cpu().numpy()})
        out = []

        def side_account(side: str, r: int) -> Account:
            row = int(evr[f"{side}_row"][r])
            return Account(
                id=u128.to_int(acc["id_hi"][row], acc["id_lo"][row]),
                debits_pending=u128.to_int(
                    evr[f"{side}_dp_hi"][r], evr[f"{side}_dp_lo"][r]),
                debits_posted=u128.to_int(
                    evr[f"{side}_dpos_hi"][r], evr[f"{side}_dpos_lo"][r]),
                credits_pending=u128.to_int(
                    evr[f"{side}_cp_hi"][r], evr[f"{side}_cp_lo"][r]),
                credits_posted=u128.to_int(
                    evr[f"{side}_cpos_hi"][r], evr[f"{side}_cpos_lo"][r]),
                user_data_128=u128.to_int(
                    acc["ud128_hi"][row], acc["ud128_lo"][row]),
                user_data_64=u64(acc["ud64"][row]),
                user_data_32=int(acc["ud32"][row]),
                ledger=int(acc["ledger"][row]),
                code=int(acc["code"][row]),
                flags=int(evr[f"{side}_flags"][r]),
                timestamp=u64(acc["ts"][row]),
            )

        for r in range(n_e):
            tflags = int(evr["tflags"][r])
            p_row = int(evr["p_row"][r])
            out.append(AccountEventRecord(
                timestamp=u64(evr["ts"][r]),
                dr_account=side_account("dr", r),
                cr_account=side_account("cr", r),
                transfer_flags=None if tflags == 0xFFFFFFFF else tflags,
                transfer_pending_status=TransferPendingStatus(
                    int(evr["pstat"][r])),
                transfer_pending=(_transfer_from_row(xfr, p_row, None)
                                  if p_row >= 0 else None),
                amount_requested=u128.to_int(evr["areq_hi"][r],
                                             evr["areq_lo"][r]),
                amount=u128.to_int(evr["amt_hi"][r], evr["amt_lo"][r]),
            ))
        return out

    def from_host(self, sm: StateMachineOracle) -> None:
        """Rebuild the device state from a host oracle state. Both stores
        pack in applied-timestamp order, the canonical row order the state
        digest indexes; the hash tables are rebuilt by the JAX package's
        insert sequence (ids in row order, then the orphans sorted).
        The new state's storage drops the window graphs at the next
        window (`WindowGraphs.check_state`)."""
        self.resolve_windows()  # pipeline ordering
        # Queued deltas drain into the old mirror first: kept when `sm`
        # is that mirror, dropped with it when `sm` replaces it.
        if self.mirror is not None:
            self.drain_mirror()
        self._mirror_chunks = []
        accounts = sorted(sm.accounts.values(), key=lambda a: a.timestamp)
        transfers = [sm.transfers[t]
                     for t in sm.transfer_by_timestamp.values()]
        assert len(accounts) <= self.a_cap and len(transfers) <= self.t_cap
        self.state = st = init_state(self.a_cap, self.t_cap,
                                     device=self.device)
        self._acct_row = {a.id: r for r, a in enumerate(accounts)}
        self._xfer_row = {t.id: r for r, t in enumerate(transfers)}

        a_u64, a_bal = _pack_account_rows(accounts)
        self._write_rows(st["accounts"], np.arange(len(accounts)),
                         {"u64": a_u64, "bal": a_bal}, len(accounts))
        self._ht_insert_chunks("acct_ht", [(a.id, r) for r, a
                                           in enumerate(accounts)])

        x_u64 = _pack_transfer_rows(
            transfers,
            lambda o: int(sm.pending_status.get(
                o.timestamp, TransferPendingStatus.none)),
            lambda aid, dump: self._acct_row.get(aid, dump), self.a_cap)
        self._write_rows(st["transfers"], np.arange(len(transfers)),
                         {"u64": x_u64}, len(transfers))
        self._ht_insert_chunks(
            "xfer_ht", [(t.id, r) for r, t in enumerate(transfers)]
            + [(oid, ORPHAN_VAL) for oid in sorted(sm.orphaned)])

        self._set_scalars(sm)
        n_e = len(sm.account_events)
        assert n_e <= ev_cap(st["events"]), "e_cap exceeded"
        self._write_rows(st["events"], np.arange(n_e),
                         self._event_cols(sm.account_events), n_e)
        self._events_pushed = n_e
        self._events_seen_abs = sm.events_base + n_e
        self._xfer_rows_dev = len(self._xfer_row)
        # Everything is device-resident now.
        for c in (sm.accounts, sm.transfers, sm.pending_status, sm.expiry,
                  sm.orphaned):
            c.dirty_dev.clear()

    def _write_rows(self, store: dict, rows, cols: dict, count: int) -> None:
        """Scatter packed host rows (uint64 matrices) into a store's
        matrices at `rows` and set its row count."""
        if len(rows):
            idx = torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(
                self.device)
            for k, v in cols.items():
                store[k][idx] = torch.from_numpy(
                    np.ascontiguousarray(v).view(np.int64)).to(self.device)
        store["count"].fill_(count)

    def _ht_insert_chunks(self, table_key: str, keys_vals: list) -> None:
        """Insert (u128 key, row) pairs into a device hash table, N_PAD at
        a time (the JAX package's chunking)."""
        for lo_i in range(0, len(keys_vals), N_PAD):
            chunk = keys_vals[lo_i:lo_i + N_PAD]
            hi, lo = u128.from_ints([k for k, _ in chunk])
            vals = torch.tensor([v for _, v in chunk], dtype=torch.int32,
                                device=self.device)
            self.state[table_key], ok = ht_insert(
                self.state[table_key],
                torch.from_numpy(hi).to(self.device),
                torch.from_numpy(lo).to(self.device), vals,
                torch.ones(len(chunk), dtype=torch.bool, device=self.device))
            assert bool(ok), f"{table_key} overflow: raise capacities"

    def _set_scalars(self, sm: StateMachineOracle) -> None:
        st = self.state
        st["acct_key_max"].fill_(s64(sm.accounts_key_max or 0))
        st["xfer_key_max"].fill_(s64(sm.transfers_key_max or 0))
        st["pulse_next"].fill_(s64(sm.pulse_next_timestamp))
        st["commit_ts"].fill_(s64(sm.commit_timestamp))

    def _mirror_route(self) -> bool:
        """True if this batch runs on the held host mirror. Past
        MIRROR_PROBE_INTERVAL batches it probes the device tiers instead,
        keeping the mirror until a tier takes a batch: the pushes kept
        the device in sync and a tier that falls back changes nothing, so
        a failed probe reuses the mirror with no rebuild."""
        if self._wt:
            # The mirror always exists: the hard-regime flag carries the
            # hysteresis.
            if not self._hard_regime:
                return False
        elif self.mirror is None:
            return False
        self._mirror_batches += 1
        if self._mirror_batches > self.MIRROR_PROBE_INTERVAL:
            self._probe_pending = True
            return False
        return True

    def _probe_succeeded(self) -> None:
        """A device tier took a batch: a held mirror is stale now (the
        tier changed the device state), so it is dropped. A write-through
        mirror is permanent (the tier's delta reaches it): only the hard
        regime ends."""
        if self._wt:
            self._hard_regime = False
        else:
            self.mirror = None
        self._probe_pending = False
        self._mirror_batches = 0

    def _enter_mirror(self) -> StateMachineOracle:
        self.mirror = self.to_host()
        self._enable_dev_tracking(self.mirror)
        self._mirror_batches = 1
        # Everything in the mirror is already on the device.
        for c in (self.mirror.accounts, self.mirror.transfers,
                  self.mirror.pending_status, self.mirror.expiry,
                  self.mirror.orphaned):
            c.dirty.clear()
            c.dirty_dev.clear()
        return self.mirror

    def _event_cols(self, records: list) -> dict:
        """Host AccountEventRecords -> the packed ring row matrix."""
        return _pack_event_rows(records, self._acct_row, self._xfer_row,
                                self.a_cap)

    @staticmethod
    def _enable_dev_tracking(sm: StateMachineOracle) -> None:
        """Turn on the device-push dirty channel of a mirror's containers
        (off by default: nothing else would clear it), and swap in the
        lazy columnar containers (`lazy_mirror.py`) the write-through
        delta registers created rows in without building objects."""
        sm.transfers = LazyTransferDict.adopt(sm.transfers)
        sm.account_events = LazyEventList.adopt(sm.account_events)
        for c in (sm.accounts, sm.transfers, sm.pending_status, sm.expiry,
                  sm.orphaned):
            c.track_dev = True
            c.dirty_dev.clear()

    def _maybe_recycle_ring(self) -> None:
        """With recycle_events, every ring row has been consumed (applied
        to the mirror or taken from it), so the ring's count rewinds to 0
        in place — unless pipelined windows are in flight, which still
        append at the current count; the pipeline's resolve recycles."""
        if not (self._wt and self.recycle_events):
            return
        if self._tickets or self._events_pushed == 0:
            return
        self.state["events"]["count"].fill_(0)
        self._events_pushed = 0

    def _clear_dirty_dev(self) -> None:
        """What a delta just applied to the mirror came from the device,
        so the next _push_dirty must not push it back (an orphan id
        inserted twice would take two hash-table slots). The durable
        channel (.dirty) is left alone."""
        sm = self.mirror
        for c in (sm.accounts, sm.transfers, sm.pending_status, sm.expiry,
                  sm.orphaned):
            c.dirty_dev.clear()

    def _note_fb(self, out) -> None:
        """Count one final fallback's per-cause flags."""
        causes = out.get("fb_causes")
        if not causes:
            return
        names = list(causes)
        flags = torch.stack([torch.as_tensor(causes[k]) for k in names])
        for k, v in zip(names, flags.cpu().tolist()):
            if v:
                self.fallback_causes[k] = self.fallback_causes.get(k, 0) + 1

    def _mirror_for_fallback(self) -> StateMachineOracle:
        self.fallbacks += 1
        self.drain_mirror()
        if self._probe_pending:
            self._probe_pending = False
            self._mirror_batches = 1  # the probe failed: the regime goes on
        if self._wt and not self._hard_regime:
            self._hard_regime = True
            self._mirror_batches = 1
        return self.mirror if self.mirror is not None else self._enter_mirror()

    def _fallback_transfers(self, transfers, timestamp):
        results = self._mirror_for_fallback().create_transfers(transfers,
                                                              timestamp)
        self._push_dirty()
        return results

    def _fallback_accounts(self, accounts, timestamp):
        results = self._mirror_for_fallback().create_accounts(accounts,
                                                             timestamp)
        self._push_dirty()
        return results

    def _push_dirty(self) -> None:
        """Scatter the mirror's dirty objects into the device state (the
        incremental inverse of from_host), in the JAX package's order:
        accounts (updates, and new rows in applied-timestamp order),
        transfers (new rows in commit order), pending-status flips and
        expiry changes on existing rows, orphaned ids, new history rows,
        the scalars."""
        sm = self.mirror
        st = self.state
        acc, xfr = st["accounts"], st["transfers"]

        # ---- accounts: updates + inserts
        dirty_accounts = sorted(a for a in sm.accounts.dirty_dev
                                if a in sm.accounts)
        sm.accounts.dirty_dev.clear()
        if dirty_accounts:
            new_ids = sorted(
                (a for a in dirty_accounts if a not in self._acct_row),
                key=lambda a: sm.accounts[a].timestamp)
            next_row = int(acc["count"])
            assert next_row + len(new_ids) <= self.a_cap, "a_cap exceeded"
            for aid in new_ids:
                self._acct_row[aid] = next_row
                next_row += 1
            u64m, bal = _pack_account_rows(
                [sm.accounts[a] for a in dirty_accounts])
            self._write_rows(acc, [self._acct_row[a] for a in dirty_accounts],
                             {"bal": bal, "u64": u64m}, next_row)
            if new_ids:
                self._ht_insert_chunks(
                    "acct_ht", [(a, self._acct_row[a]) for a in new_ids])

        # ---- transfers: inserts (immutable rows), in commit order
        dirty_transfers = sorted(t for t in sm.transfers.dirty_dev
                                 if t in sm.transfers)
        sm.transfers.dirty_dev.clear()
        new_tids = sorted(
            (t for t in dirty_transfers if t not in self._xfer_row),
            key=lambda t: sm.transfers[t].timestamp)
        if new_tids:
            next_row = int(xfr["count"])
            assert next_row + len(new_tids) <= self.t_cap, "t_cap exceeded"
            rows = list(range(next_row, next_row + len(new_tids)))
            for tid, r in zip(new_tids, rows):
                self._xfer_row[tid] = r
            u64m = _pack_transfer_rows(
                [sm.transfers[t] for t in new_tids],
                lambda o: int(sm.pending_status.get(o.timestamp, 0)),
                lambda aid, dump: self._acct_row.get(aid, dump), self.a_cap)
            self._write_rows(xfr, rows, {"u64": u64m}, rows[-1] + 1)
            self._ht_insert_chunks("xfer_ht", list(zip(new_tids, rows)))

        # ---- pending-status flips + expiry changes on existing rows
        dirty_pending = sorted(sm.pending_status.dirty_dev)
        sm.pending_status.dirty_dev.clear()
        flip = [(self._xfer_row[sm.transfer_by_timestamp[ts]],
                 int(sm.pending_status[ts]))
                for ts in dirty_pending
                if sm.transfer_by_timestamp.get(ts) in self._xfer_row]
        if flip:
            # pstat lives alone in its packed column, so the write cannot
            # clobber a partner field.
            rows = torch.tensor([r for r, _ in flip], device=self.device)
            vals = pack32(torch.tensor([v for _, v in flip],
                                       device=self.device))
            xfr["u64"][rows, XF_P32_POS["pstat"][0]] = vals
        dirty_expiry = sorted(sm.expiry.dirty_dev)
        sm.expiry.dirty_dev.clear()
        exp = [(self._xfer_row[sm.transfer_by_timestamp[ts]],
                s64(sm.expiry.get(ts, 0)))
               for ts in dirty_expiry
               if sm.transfer_by_timestamp.get(ts) in self._xfer_row]
        if exp:
            rows = torch.tensor([r for r, _ in exp], device=self.device)
            xfr["u64"][rows, XF_U64_IDX["expires"]] = torch.tensor(
                [v for _, v in exp], dtype=torch.int64, device=self.device)

        # ---- orphaned ids (inline in the transfer table, val sentinel)
        dirty_orphans = sorted(sm.orphaned.dirty_dev)
        sm.orphaned.dirty_dev.clear()
        if dirty_orphans:
            self._ht_insert_chunks("xfer_ht",
                                   [(o, ORPHAN_VAL) for o in dirty_orphans])

        # ---- account_events: append the mirror's new history rows
        new_events = sm.account_events[self._events_seen_abs
                                       - sm.events_base:]
        if new_events:
            evr = st["events"]
            next_row = int(evr["count"])
            assert next_row + len(new_events) <= ev_cap(evr), \
                "e_cap exceeded"
            self._write_rows(evr, np.arange(next_row,
                                            next_row + len(new_events)),
                             self._event_cols(new_events),
                             next_row + len(new_events))
            self._events_pushed += len(new_events)
        self._events_seen_abs += len(new_events)
        self._maybe_recycle_ring()

        self._set_scalars(sm)
        # Chunks drain before every push, so the row map counts the
        # device's transfer rows again.
        self._xfer_rows_dev = len(self._xfer_row)

    # ------------------------------------------------ write-through deltas

    def _delta_fetch_start(self, n_new: int) -> _DeltaFetchHandle:
        """Gather one bounded delta on the device — the n_new appended
        transfer and event rows at the host cursors and the derived
        columns — and start its copy to the host. Fixed sizes (256 /
        N_PAD / 8·N_PAD rows) keep the pinned buffers to three shapes.
        The columns resolve at the drain, off the commit path."""
        t0 = self._xfer_rows_dev
        e0 = self._events_pushed
        t_len = self.state["transfers"]["u64"].shape[0]
        e_len = ev_cap(self.state["events"]) + 1
        size = _delta_bucket(n_new)
        size_t, size_e = min(size, t_len), min(size, e_len)
        assert n_new <= size_t and n_new <= size_e
        t_start = max(0, min(t0, t_len - size_t))
        e_start = max(0, min(e0, e_len - size_e))
        out = _delta_gather_body(self.state, t_start, e_start, size_t,
                                 size_e)
        return _DeltaFetchHandle(out, t0, t0 - t_start, e0 - e_start)

    def _ev_delta_fetch_start(self, n_new: int) -> _DeltaFetchHandle:
        """The half-width fetch: the event rows only."""
        e0 = self._events_pushed
        e_len = ev_cap(self.state["events"]) + 1
        size_e = min(_delta_bucket(n_new), e_len)
        assert n_new <= size_e
        e_start = max(0, min(e0, e_len - size_e))
        out = _ev_delta_gather_host(self.state, e_start, size_e)
        return _DeltaFetchHandle(out, self._xfer_rows_dev, 0, e0 - e_start)

    def _track_pending_cols(self, *cols) -> None:
        """At most 32 unloaded delta fetches may hold buffers; past that
        the oldest load (their copies have long finished)."""
        self._pending_cols = [cs for cs in self._pending_cols
                              if not cs[0].loaded]
        self._pending_cols.append(cols)
        while len(self._pending_cols) > 32:
            for c in self._pending_cols.pop(0):
                c.load()

    def _queue_chunk(self, tc, ec, derc, t0: int, n_new: int,
                     orphan_ids, exact: bool = False) -> None:
        """Queue one batch's delta for the drain (n_new 0: its orphans
        only, if any) and advance the host cursors. With
        retain_flush_columns the same columns are retained for the
        durable flush, and `exact` retains an entry even for a batch
        that created nothing and poisoned nothing (the all_or_nothing
        windows' one entry a prepare)."""
        op_no = self._op_seq
        self._op_seq += 1
        if self.retain_flush_columns and (n_new or orphan_ids or exact):
            # abs_start: the chunk's absolute event index, the flusher's
            # double-flush watermark.
            self._flush_columns.append(
                (tc, ec, derc, n_new, self._events_seen_abs, orphan_ids))
        if n_new:
            self._track_pending_cols(tc, ec, derc)
            self._mirror_chunks.append((tc, ec, derc, t0, n_new,
                                        orphan_ids, op_no))
            self._xfer_rows_dev += n_new
            self._events_pushed += n_new
            self._events_seen_abs += n_new
        elif orphan_ids:
            self._mirror_chunks.append((None, None, None, 0, 0, orphan_ids,
                                        op_no))

    def _capture_fast_delta_transfers(self, ev: dict, st_np) -> None:
        """Write-through of one device batch, deferred: fetch its bounded
        delta and queue it as a columnar chunk, which drain_mirror
        materializes into the mirror at the next read."""
        n_new, orphan_ids = _batch_delta_stats(ev, st_np)
        if n_new:
            h = self._delta_fetch_start(n_new)
            self._queue_chunk(_LazyCols(h, "t", 0, n_new),
                              _LazyCols(h, "e", 0, n_new),
                              _LazyCols(h, "der", 0, n_new), h.t0, n_new,
                              orphan_ids)
            self._clear_dirty_dev()
            self._maybe_recycle_ring()
        else:
            self._queue_chunk(None, None, None, 0, 0, orphan_ids)
            self._clear_dirty_dev()

    def _window_chunks(self, evs, st_slices, timestamps, e_only: bool,
                       handle, exact: bool = False) -> None:
        """Queue one chunk a prepare over a window's fetch (its created
        rows are contiguous, in commit order). e_only: the transfer and
        derived columns synthesize on the host."""
        off = 0
        for b, (ev, st) in enumerate(zip(evs, st_slices)):
            n_new, orphan_ids = _batch_delta_stats(ev, st)
            if not n_new:
                self._queue_chunk(None, None, None, 0, 0, orphan_ids,
                                  exact)
                continue
            if e_only:
                tc = _SynthCols(_synth_t_cols, ev, st, timestamps[b])
                derc = _SynthCols(_synth_der_cols, ev, st)
            else:
                tc = _LazyCols(handle, "t", off, n_new)
                derc = _LazyCols(handle, "der", off, n_new)
            self._queue_chunk(tc, _LazyCols(handle, "e", off, n_new),
                              derc, handle.t0 + off, n_new, orphan_ids)
            off += n_new

    def _capture_window_delta(self, evs: list, st_slices: list,
                              timestamps: list,
                              exact_chunks: bool = False) -> None:
        """Write-through of a synchronous window: ONE fetch for the
        window's created rows (the window kernels append them
        contiguously in commit order) a group of at most 8·N_PAD rows,
        split into one chunk a prepare. A window with no post/void,
        imported or balancing flag fetches the event rows only (the
        rest synthesizes on the host)."""
        e_only = all(not (np.asarray(ev["flags"]) & _F_NOT_SYNTH).any()
                     for ev in evs)
        news = [int((np.asarray(st) == _CREATED).sum()) for st in st_slices]
        lo = 0
        while lo < len(evs):
            hi, total = lo, 0
            while hi < len(evs) and (hi == lo
                                     or total + news[hi] <= 8 * N_PAD):
                total += news[hi]
                hi += 1
            handle = None
            if total:
                handle = (self._ev_delta_fetch_start(total) if e_only
                          else self._delta_fetch_start(total))
            self._window_chunks(evs[lo:hi], st_slices[lo:hi],
                                timestamps[lo:hi], e_only, handle,
                                exact_chunks)
            lo = hi
        self._clear_dirty_dev()
        self._maybe_recycle_ring()

    def _register_window_capture(self, tk: WindowTicket,
                                 st_slices) -> None:
        """Write-through of a pipelined window at its resolve: its gather
        was issued at submit with device-computed starts; the offsets
        into it are recomputed here from the host cursors, by the same
        clamps."""
        if self.recycle_events:
            # A ring window consumed the ring from row 0.
            self._events_pushed = 0
        handle = None
        if any((np.asarray(st) == _CREATED).any() for st in st_slices):
            t0, e0 = self._xfer_rows_dev, self._events_pushed
            size_t, size_e = tk.size
            t_len = self.state["transfers"]["u64"].shape[0]
            e_len = ev_cap(self.state["events"]) + 1
            t_start = max(0, min(t0, t_len - size_t))
            e_start = max(0, min(e0, e_len - size_e))
            handle = _DeltaFetchHandle(tk.gather, t0, t0 - t_start,
                                       e0 - e_start, eager_copy=False)
        tk.gather = None
        self._window_chunks(tk.evs[:len(st_slices)], st_slices, tk.tss,
                            tk.e_only, handle)
        self._clear_dirty_dev()

    def take_flush_columns(self, count: int = None) -> list:
        """Pop the retained flush entries for the durable flusher's
        column path: all of them (count=None), or exactly the oldest
        `count` (one prepare's worth in a window commit, so each op's
        flush carries that op's effects only)."""
        if count is None:
            cols, self._flush_columns = self._flush_columns, []
            return cols
        # A short pop would hand later ops' rows to this one and show only
        # as a distant byte divergence between replicas: fail here.
        assert len(self._flush_columns) >= count, \
            (len(self._flush_columns), count)
        cols = self._flush_columns[:count]
        self._flush_columns = self._flush_columns[count:]
        return cols

    def drain_mirror(self) -> None:
        """Materialize every queued delta into the host mirror. Called
        before any read of the mirror (the state machine's reads, a hard
        batch, expiry, to_host); a no-op when nothing is queued."""
        self.resolve_windows()  # pipeline ordering
        if not self._mirror_chunks:
            return
        chunks, self._mirror_chunks = self._mirror_chunks, []
        # Start every pending copy first, so the later chunks' bytes move
        # while the earlier ones register.
        for cols in chunks:
            for c in cols[:3]:
                if (cols[4] and isinstance(c, _LazyCols) and not c.loaded
                        and c._handle is not None):
                    c._handle.start_copy()
                    break
        for t, e, der, t0, n_new, orphan_ids, _op in chunks:
            for oid in orphan_ids:
                self.mirror.orphaned.add(oid)
            if n_new:
                self._materialize_delta_transfers(t, e, der, t0, n_new)
        self._clear_dirty_dev()
        if constants.VERIFY:
            self._verify_drained(chunks)

    def _verify_drained(self, chunks) -> None:
        """Extra-check mode: spot-audit device rows against the just-
        drained mirror (the write-through contract). Two rows of the
        newest chunk by default; with verify_spot_rate >= 1.0 every row
        of every chunk (the chaos runs), so "auditor-clean" is
        exhaustive. The lookups launch the probe and the row gather."""
        rate = self.verify_spot_rate
        checked = 0
        for t, e, der, t0, n_new, _, op_no in reversed(chunks):
            if not n_new:
                continue
            k = n_new if rate >= 1.0 else min(2, n_new)
            xfer_ids = [u128.to_int(t["id_hi"][i], t["id_lo"][i])
                        for i in range(k)]
            # Plus a stable anchor, the oldest transfer, so drift on rows
            # the batch never touched (stale pending flips, bad pushes)
            # is caught too.
            if checked == 0 and self.mirror.transfers:
                xfer_ids.append(next(iter(self.mirror.transfers)))
            self._verify_mirror_spot(
                [u128.to_int(der["dr_id_hi"][i], der["dr_id_lo"][i])
                 for i in range(k)],
                xfer_ids,
                ctx=f"op {op_no}, device rows {t0}..{t0 + n_new}")
            checked += 1
            if rate < 1.0:
                break

    def _verify_mirror_spot(self, acct_ids: list, xfer_ids: list,
                            ctx: str = "") -> None:
        """VERIFY check: device-resident rows and the host mirror must
        agree object for object after a drain. A divergence raises
        MirrorDivergence naming the op that produced the chunk and every
        differing field."""
        sm = self.mirror
        where = f" at {ctx}" if ctx else ""

        def diff(got, want) -> str:
            if got is None:
                return "object missing on device"
            if want is None:
                return "object missing in mirror"
            return "differing fields: " + ", ".join(
                f"{f.name}(device={getattr(got, f.name)!r}, "
                f"mirror={getattr(want, f.name)!r})"
                for f in dataclasses.fields(got)
                if getattr(got, f.name) != getattr(want, f.name))

        got_a = {a.id: a for a in self.lookup_accounts(acct_ids)}
        for aid in acct_ids:
            got, want = got_a.get(aid), sm.accounts.get(aid)
            if got != want:
                raise MirrorDivergence(
                    f"verify: device/mirror divergence on account "
                    f"{aid}{where}: {diff(got, want)}")
        got_t = {t.id: t for t in self.lookup_transfers(xfer_ids)}
        for tid in xfer_ids:
            got, want = got_t.get(tid), sm.transfers.get(tid)
            if got != want:
                raise MirrorDivergence(
                    f"verify: device/mirror divergence on transfer "
                    f"{tid}{where}: {diff(got, want)}")

    def _materialize_delta_transfers(self, t, e, der, t0: int,
                                     n_new: int) -> None:
        """Register one chunk with the mirror columnarly: the created
        transfers as lazy rows of its LazyTransferDict, the touched
        accounts' final states in one vectorized pass, the history as one
        lazy segment; the pending-status flips (order-dependent pulse
        bookkeeping) as a loop over that subset only. Every value a
        reader sees is the oracle's (oracle `_create_transfer`)."""
        sm = self.mirror
        ids = [(h << 64) | lo
               for h, lo in zip(t["id_hi"].tolist(), t["id_lo"].tolist())]
        ts_list = e["ts"].tolist()
        chunk = DeltaChunk(t, e, der, sm, ids)
        transfers = sm.transfers
        assert isinstance(transfers, LazyTransferDict), \
            "a write-through mirror holds a LazyTransferDict"
        transfers.register(ids, chunk)
        sm.transfer_by_timestamp.update(zip(ts_list, ids))
        self._xfer_row.update(zip(ids, range(t0, t0 + n_new)))
        last_ts = ts_list[-1]
        if sm.transfers_key_max is None or last_ts > sm.transfers_key_max:
            sm.transfers_key_max = last_ts
        sm.commit_timestamp = last_ts

        sm.accounts.dirty.update(apply_account_finals(sm, e, der))

        pstat_np = np.asarray(e["pstat"])
        flips = np.nonzero(pstat_np != 0)[0]
        if flips.size:
            P = TransferPendingStatus
            pend_code = int(P.pending)
            pstat_l = pstat_np[flips].tolist()
            ts_l = np.asarray(e["ts"])[flips].tolist()
            pts_l = np.asarray(der["p_ts"])[flips].tolist()
            timeout_l = np.asarray(t["timeout"])[flips].tolist()
            pending_raw = sm.pending_status
            pset = dict.__setitem__
            touched: list = []
            for j, pstat in enumerate(pstat_l):
                if pstat == pend_code:
                    ts = ts_l[j]
                    pset(pending_raw, ts, P.pending)
                    touched.append(ts)
                    timeout = timeout_l[j]
                    if timeout:
                        expires_at = ts + timeout * NS_PER_S
                        sm.expiry[ts] = expires_at
                        if expires_at < sm.pulse_next_timestamp:
                            sm.pulse_next_timestamp = expires_at
                else:  # a post or void releases its pending
                    pts = pts_l[j]
                    pset(pending_raw, pts, P(pstat))
                    touched.append(pts)
                    # expiry[pts] is pts + timeout while the pending is
                    # live with a timeout, absent otherwise.
                    ea = sm.expiry.pop(pts, None)
                    if ea is not None and sm.pulse_next_timestamp == ea:
                        sm.pulse_next_timestamp = TIMESTAMP_MIN
            pending_raw.dirty.update(touched)

        sm.account_events.extend_lazy(chunk, n_new)

    def _apply_fast_delta_accounts(self, st_np) -> None:
        """Write-through of one device accounts batch (oracle
        `_create_account`'s success path): its new rows, sliced on the
        device, as Account objects. Queued transfer chunks drain first,
        so the mirror's commit timestamp stays monotonic."""
        self.drain_mirror()
        sm = self.mirror
        n_new = int((st_np == np.uint32(int(CreateAccountStatus.created)))
                    .sum())
        if n_new == 0:
            return
        a0 = len(self._acct_row)
        acc = self.state["accounts"]
        named = ac_named({k: acc[k][a0:a0 + n_new].cpu().numpy()
                          for k in ("u64", "bal")})
        a = {k: (v.view(np.uint64) if k in AC_U64_IDX else v).tolist()
             for k, v in named.items()}
        for k in range(n_new):
            aid = (a["id_hi"][k] << 64) | a["id_lo"][k]
            acct = Account(
                id=aid,
                debits_pending=_balance_int(a, "dp", k),
                debits_posted=_balance_int(a, "dpos", k),
                credits_pending=_balance_int(a, "cp", k),
                credits_posted=_balance_int(a, "cpos", k),
                user_data_128=(a["ud128_hi"][k] << 64) | a["ud128_lo"][k],
                user_data_64=a["ud64"][k],
                user_data_32=a["ud32"][k],
                ledger=a["ledger"][k],
                code=a["code"][k],
                flags=a["flags"][k],
                timestamp=a["ts"][k],
            )
            sm.accounts[aid] = acct
            sm.account_by_timestamp[acct.timestamp] = aid
            self._acct_row[aid] = a0 + k
            if (sm.accounts_key_max is None
                    or acct.timestamp > sm.accounts_key_max):
                sm.accounts_key_max = acct.timestamp
            sm.commit_timestamp = acct.timestamp
        self._clear_dirty_dev()

    # ------------------------------------------------------------- windows

    def _pack_window(self, route: str, evs, timestamps, n_pad: int):
        """The window's lane matrix in host memory (pinned on the card;
        the chain route's stacked (lanes, K, n_pad), the flat tiers'
        (lanes, K·n_pad): the same bytes) and the ns it took. The stager
        thread runs it: it reads and writes no ledger state."""
        t0 = time.perf_counter_ns()
        K = len(evs)
        shape = ((len(_LANES), K, n_pad)
                 if route in ("chain", "partitioned_chain")
                 else (len(_LANES), K * n_pad))
        host = self.windows.host_lanes(shape, lambda out: fill_window(
            out.reshape(len(_LANES), K, n_pad), evs, timestamps, n_pad))
        return host, time.perf_counter_ns() - t0

    def _pack(self, route: str, evs, timestamps, n_pad: int, host=None):
        """The window's lane matrix on the device: `host` (a staged pack)
        or one packed here, copied in on the main stream."""
        if host is None:
            host, _ = self._pack_window(route, evs, timestamps, n_pad)
        self.windows.check_state(self.state)
        return self.windows.upload(host)

    def _dispatch(self, route: str, lanes, n_pad: int, poison=None,
                  ring: bool = False):
        """One window on `route` (its ring kernel with `ring`): eagerly,
        or one replay of its graph on the card. Returns the route's
        outputs."""
        key = (route, lanes.shape[1] if route == "chain"
               else lanes.shape[1] // n_pad, n_pad) + (("ring",) if ring
                                                        else ())
        return self.windows.run(key, _window_call(route, ring), self.state,
                                lanes, poison)

    def _count_route(self, route: str) -> None:
        """One window dispatched via `route`; its latency class: scan (the
        chain), fallback (per batch) or flat (a super tier)."""
        self.window_routes[route] = self.window_routes.get(route, 0) + 1
        self.last_window_route = route
        self.last_window_tier = ("scan" if route == "chain" else
                                 "fallback" if route == "per_batch"
                                 else "flat")

    def _note_chain_fb(self, out, k: int) -> None:
        """Count the causes of the chain's fallback at prepare k (the first
        one; later prepares carry only 'forced', the poison)."""
        for cause, v in out["fb_causes"].items():
            if v[k]:
                self.fallback_causes[cause] = (
                    self.fallback_causes.get(cause, 0) + 1)
                self.chain_batch_fallbacks[cause] = (
                    self.chain_batch_fallbacks.get(cause, 0) + 1)

    def _resolve_chain_prefix(self, out, ns) -> tuple:
        """A chain window's clean prefix from its harvested outputs:
        (k, results), k the first prepare that fell back (W when none).
        Prepares [0, k) committed on the device; the counters move here,
        and replaying prepare k onward is the caller's."""
        W = len(ns)
        fb = out["fallback"]
        k = int(np.argmax(fb)) if fb.any() else W
        results = _window_results(out["r_status"][:k], out["r_ts"][:k],
                                  ns[:k], out["r_status"].shape[1])
        if k:
            self.fast_batches += k
            self._probe_succeeded()
        if k < W:
            self.window_fallbacks += 1
            self._note_chain_fb(out, k)
        return k, results

    def _window_plan(self, evs):
        """The route of a pipelined window, or None (the synchronous path
        takes it): None for one prepare, in the mirror regime, with an
        imported flag (the synchronous path's super_imported tier takes
        it) or, writing through, with more created rows than one delta
        gather holds; super_balancing for balancing flags; super_deep for
        closing flags, in-window pending references or the limit-breach
        regime; else the chain. Shared by stage_window and submit_window,
        so a staged pack is the one submit_window would pack. In the
        partitioned attach mode: partitioned_chain for a window of
        several prepares that all pre-route plain, else None (the
        synchronous path's per-batch partitioned ladder)."""
        if self._part_router is not None:
            r = self._part_router
            if (len(evs) < 2 or _has_imported(evs)
                    or any(r.route(e) != "plain" for e in evs)):
                return None
            return ("partitioned_chain",
                    _pad_bucket(max(len(e["id_lo"]) for e in evs)))
        if not (len(evs) > 1 and not self._mirror_route()):
            return None
        if _has_imported(evs):
            return None
        if self._wt:
            t_len = self.state["transfers"]["u64"].shape[0]
            e_len = ev_cap(self.state["events"]) + 1
            if sum(len(e["id_lo"]) for e in evs) > min(32 * N_PAD, t_len,
                                                       e_len):
                return None
        balancing = _has_balancing(evs)
        deep = not balancing and (
            self._fixpoint_first or _has_closing(evs)
            or _evs_pend_refs(evs))
        return ("super_balancing" if balancing
                else "super_deep" if deep else "chain",
                _pad_bucket(max(len(e["id_lo"]) for e in evs)))

    def stage_window(self, evs: list[dict], timestamps: list[int]) -> bool:
        """Pack the NEXT window into pinned host memory on the stager
        thread while the current one runs. The next submit_window of the
        same window (the same prepare dicts, the same timestamps, the same
        route) takes the staged pack; anything else packs inline, the
        same bytes. The stager reads no ledger state and moves nothing to
        the device: the copy in stays on the main stream at submit.
        Returns True when a pack was staged."""
        if not self.overlap_staging:
            return False
        plan = self._window_plan(evs)
        if plan is None:
            self._staged = None
            return False
        route, n_pad = plan
        if self._stager is None:
            self._stager = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tb-window-stager")
        fut = self._stager.submit(self._pack_window, route, list(evs),
                                  list(timestamps), n_pad)
        # Strong references keep the prepare dicts' identities stable.
        self._staged = (list(evs), [int(t) for t in timestamps], route,
                        n_pad, fut)
        return True

    def _consume_staged(self, evs, timestamps, route: str, n_pad: int):
        """The staged pack if it is exactly this window on this route,
        else None (the caller packs inline). A hit charges only the wait
        on the stager to stall_ms."""
        staged, self._staged = self._staged, None
        if staged is None:
            return None
        s_evs, s_tss, s_route, s_n_pad, fut = staged
        if not (s_route == route and s_n_pad == n_pad
                and len(s_evs) == len(evs)
                and all(a is b for a, b in zip(s_evs, evs))
                and s_tss == [int(t) for t in timestamps]):
            self.staging_stats["misses"] += 1
            fut.cancel()
            return None
        t0 = time.perf_counter_ns()
        host, pack_ns = fut.result()
        wait_ns = time.perf_counter_ns() - t0
        st = self.staging_stats
        st["staged"] += 1
        st["stall_ms"] += wait_ns / 1e6
        st["work_ms"] += max(pack_ns, wait_ns) / 1e6
        self.tracer.record_span(Event.window_stage, t0, wait_ns,
                                mode="overlapped", route=route)
        return host

    def staged_matches(self, evs: list[dict],
                       timestamps: list[int]) -> bool:
        """True when the staged pack is exactly this window (the test
        _consume_staged applies, route aside)."""
        staged = self._staged
        if staged is None:
            return False
        s_evs, s_tss = staged[0], staged[1]
        return (len(s_evs) == len(evs)
                and all(a is b for a, b in zip(s_evs, evs))
                and s_tss == [int(t) for t in timestamps])

    def staging_summary(self) -> dict:
        """Windows through submit_window, staged packs consumed, misses,
        and host_stall_fraction = stall_ms / work_ms: 1.0 when every pack
        ran inline, near 0 when the packs hid behind the device."""
        st = self.staging_stats
        frac = (st["stall_ms"] / st["work_ms"]) if st["work_ms"] else None
        return {
            "overlap": bool(self.overlap_staging),
            "windows": st["windows"],
            "staged": st["staged"],
            "misses": st["misses"],
            "stall_ms": round(st["stall_ms"], 3),
            "work_ms": round(st["work_ms"], 3),
            "host_stall_fraction": (round(frac, 4)
                                    if frac is not None else None),
        }

    def shutdown_staging(self) -> None:
        """Drop a staged, undispatched window and stop the stager thread
        (a staged window that never dispatched never commits)."""
        self._staged = None
        if self._stager is not None:
            self._stager.shutdown(wait=True, cancel_futures=True)
            self._stager = None

    def release(self) -> None:
        """Give a quarantined ledger's memory back (the supervisor calls
        it before a recovery builds the replacement): the stager stops,
        the device work queued so far finishes, so no copy still writes
        into a pinned buffer, and the window graphs, tickets, queued
        deltas and state go. The ledger is unusable after this."""
        self.shutdown_staging()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.windows = None
        self._tickets = []
        self._mirror_chunks = []
        self._flush_columns = []
        self._pending_cols = []
        self.state = None
        self.mirror = None
        # The mirror's chunks and the mirror reference each other: collect
        # the cycle now, so the device rows behind its unloaded chunks go
        # with it.
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _merged_routes(self) -> dict:
        """fallback_stats()["routes"]: the ledger's route counters plus,
        in the partitioned attach mode, the router's (partitioned_chain /
        partitioned_per_batch windows, the per-cause prepares that fell
        out of a chain window)."""
        windows = dict(self.window_routes)
        cbf = dict(self.chain_batch_fallbacks)
        if self._part_router is not None:
            rr = self._part_router.stats()["routes"]
            for k, v in rr["windows"].items():
                windows[k] = windows.get(k, 0) + v
            for k, v in rr["chain_batch_fallbacks"].items():
                cbf[k] = cbf.get(k, 0) + v
        return {"windows": windows, "chain_batch_fallbacks": cbf}

    def fallback_stats(self) -> dict:
        """Host-visible routing, fallback and recovery counters: "zero
        host fallbacks" is a measured invariant. device_telemetry: the
        attached partitioned router's decoded telemetry aggregates (None
        without a router, or with its telemetry off)."""
        return {
            "host_fallbacks": self.fallbacks,
            "window_fallbacks": self.window_fallbacks,
            "fast_batches": self.fast_batches,
            "fixpoint_batches": self.fixpoint_batches,
            "deep_fixpoint_batches": self.deep_fixpoint_batches,
            "escalations": self.escalations,
            "causes": dict(self.fallback_causes),
            # Windows per route and the per-cause prepares that fell out
            # of a chain window (the attached router's merged in).
            "routes": self._merged_routes(),
            "staging": self.staging_summary(),
            "device_telemetry": (
                self._part_router.stats().get("telemetry")
                if self._part_router is not None else None),
            "recovery": {
                k: (dict(v) if isinstance(v, dict) else v)
                for k, v in self.recovery_stats.items()},
        }

    def attach_partitioned(self, router, state) -> None:
        """Serve commit windows from a partitioned mesh: every window of
        submit_window, resolve_windows' redo replays and the synchronous
        window path go through `router` (parallel/partitioned.
        PartitionedRouter) against `state`, its tuple of per-shard state
        dicts: the partitioned chain by default, the per-batch ladder for
        flagged windows and replays. The partitioned state is the ledger
        then (`partitioned_state`); the single-chip state stays at its
        attach-time snapshot and the per-batch entry points keep
        addressing it. Write-through is single-chip scope: refused."""
        assert not self._wt, \
            "attach_partitioned: write-through is single-chip scope"
        assert not self._tickets, "attach_partitioned: windows in flight"
        self._part_router = router
        self._part_state = tuple(state)
        # router.resync tears this ledger's staging down before it
        # rebuilds the state.
        router._staging_host = self

    @property
    def partitioned_state(self):
        """The partitioned state commits land on in attach mode."""
        return self._part_state

    def _submit_window_partitioned(self, evs, timestamps, ns, n_pad,
                                   host, prev):
        """submit_window in attach mode: the router's partitioned chain,
        one call a window with no host sync, the previous window's poison
        as its force_fallback; on the card one replay of the window's
        captured graph (a mesh of this ledger's device only)."""
        from ..parallel.shard_utils import _normal

        r = self._part_router
        mesh = r.mesh
        graphs = (self.windows if mesh.distinct == (_normal(self.device),)
                  else None)
        if graphs is not None:
            graphs.check_state(self._part_state)
            host = graphs.upload(host)
        outs = r.chain_dispatch(self._part_state, evs, timestamps, n_pad,
                                force_fallback=prev, staged=host,
                                graphs=graphs)
        # The router counts the window (merged into fallback_stats); the
        # ledger keeps the latency class.
        self.last_window_route = "partitioned_chain"
        self.last_window_tier = "scan"
        tk = WindowTicket(evs, timestamps, ns, n_pad, "partitioned_chain",
                          False, outs["fallback"][-1].clone(), outs)
        tk.start_harvest()
        self._tickets.append(tk)
        return tk

    def _partitioned_window_sync(self, evs, tss) -> list:
        """The synchronous window path in attach mode (synchronous
        commits and resolve-time redo replays): PartitionedRouter.
        step_window, the chain when eligible, else the per-batch ladder
        with its escalation on the device."""
        r = self._part_router
        self._part_state, results = r.step_window(self._part_state, evs,
                                                  tss)
        chain = len(evs) >= 2 and all(r.route(e) == "plain" for e in evs)
        self.last_window_route = ("partitioned_chain" if chain
                                  else "partitioned_per_batch")
        self.last_window_tier = "scan" if chain else "fallback"
        return results

    def _resolve_partitioned_prefix(self, out, tk) -> tuple:
        """A partitioned chain window's clean prefix: (k, results); the
        router absorbs its counters (batches, events a shard, cross-shard
        traffic, the causes at prepare k)."""
        W = len(tk.evs)
        fb = out["fallback"]
        k = int(np.argmax(fb)) if fb.any() else W
        self._part_router.absorb_chain_prefix(out, k, W)
        results = _window_results(out["r_status"][:k], out["r_ts"][:k],
                                  tk.ns[:k], out["r_status"].shape[1])
        if k:
            self.fast_batches += k
            self._probe_succeeded()
        if k < W:
            self.window_fallbacks += 1
        return k, results

    def submit_window(self, evs: list[dict], timestamps: list[int]):
        """Pipelined commit window: dispatch it with no host sync, the
        previous in-flight window's fallback flag as its force_fallback,
        so a fallback anywhere poisons every later window in flight and
        commit order survives without waiting. Returns a WindowTicket, or
        None when the window is not eligible (the caller resolves and
        takes create_transfers_window). Results, the write-through
        capture and counters materialize at resolve_windows().

        Writing through, the window's delta gather is issued right after
        the dispatch (eagerly, outside the window's graph) on
        device-computed starts, and its copy to the host waits for the
        drain. With recycle_events the window takes its route's ring
        kernel, which consumes the event ring from row 0, so the pipeline
        needs no recycle between windows."""
        plan = self._window_plan(evs)
        if plan is None:
            self._staged = None
            return None
        route, n_pad = plan
        ns = [len(e["id_lo"]) for e in evs]
        prev = self._tickets[-1].poison if self._tickets else None
        host = self._consume_staged(evs, timestamps, route, n_pad)
        st = self.staging_stats
        if host is None:
            # An inline pack: its whole cost is a stall the dispatch
            # waited on.
            t0 = time.perf_counter_ns()
            host, _ = self._pack_window(route, evs, timestamps, n_pad)
            dur_ns = time.perf_counter_ns() - t0
            st["stall_ms"] += dur_ns / 1e6
            st["work_ms"] += dur_ns / 1e6
            self.tracer.record_span(Event.window_stage, t0, dur_ns,
                                    mode="inline", route=route)
        st["windows"] += 1
        if st["work_ms"]:
            self.tracer.gauge(Event.host_stall_fraction,
                              round(st["stall_ms"] / st["work_ms"], 6))
        if route == "partitioned_chain":
            return self._submit_window_partitioned(evs, timestamps, ns,
                                                   n_pad, host, prev)
        lanes = self._pack(route, evs, timestamps, n_pad, host=host)
        outs = self._dispatch(route, lanes, n_pad, poison=prev,
                              ring=self._wt and self.recycle_events)
        self._count_route(route)
        fb = outs["fallback"]
        gather, size, e_only = None, (0, 0), False
        if self._wt:
            t_len = self.state["transfers"]["u64"].shape[0]
            e_len = ev_cap(self.state["events"]) + 1
            for rows in (N_PAD, 8 * N_PAD, 32 * N_PAD):
                if sum(ns) <= rows:
                    break
            size = (min(rows, t_len), min(rows, e_len))
            e_only = all(not (np.asarray(e["flags"]) & _F_NOT_SYNTH).any()
                         for e in evs)
            # The chain's per-prepare counts sum on the device (a poisoned
            # prepare counts 0), so a partial window's gather covers its
            # committed prefix.
            created = (outs["created_count"].sum() if route == "chain"
                       else outs["created_count"])
            gather = (_ev_delta_gather_window(self.state, created, size[1])
                      if e_only else
                      _xfer_delta_gather_window(self.state, created, *size))
        tk = WindowTicket(evs, timestamps, ns, n_pad, route,
                          route == "super_deep",
                          (fb[-1] if route == "chain" else fb).clone(), outs,
                          gather=gather, size=size, e_only=e_only)
        tk.start_harvest()
        self._tickets.append(tk)
        return tk

    def resolve_windows(self, count: int | None = None) -> None:
        """Resolve in-flight windows in submission order: all of them, or
        the oldest `count`. A chain window falls back per prepare: its
        clean prefix stands, and the prepare that fell back and the
        poisoned rest replay through create_transfers_window. A flat
        window falls back whole and replays. Either way every later
        window in flight was poisoned and replays too, in order, so a
        redo consumes the whole pipeline. In the partitioned attach mode
        the router absorbs a chain window's prefix and the replays go
        through its synchronous window path."""
        if not self._tickets:
            return
        if count is None:
            tickets, self._tickets = self._tickets, []
        else:
            tickets = self._tickets[:count]
            del self._tickets[:count]
        win = (self._partitioned_window_sync
               if self._part_router is not None
               else self.create_transfers_window)
        redo = False
        i = 0
        while i < len(tickets):
            tk = tickets[i]
            i += 1
            if redo:
                tk.results = ("redo", win(tk.evs, tk.tss))
                continue
            out = tk.harvest.get()
            if tk.route == "partitioned_chain":
                k, results = self._resolve_partitioned_prefix(out, tk)
            elif tk.route == "chain":
                k, results = self._resolve_chain_prefix(out, tk.ns)
                if self._wt:
                    # In ring mode this also rewinds the host cursor, as
                    # the chain reset the device ring, even when k == 0.
                    self._register_window_capture(
                        tk, [st for st, _ in results])
            if tk.route in ("chain", "partitioned_chain"):
                if k == len(tk.evs):
                    tk.results = ("ok", results)
                    continue
                # Prepare k and the poisoned rest replay, and everything
                # still in flight joins the redo, in order.
                redo = True
                tickets.extend(self._tickets)
                self._tickets = []
                results.extend(win(tk.evs[k:], tk.tss[k:]))
                tk.results = ("redo", results)
                continue
            if out["fallback"]:
                redo = True
                self._note_fb(out)
                tickets.extend(self._tickets)
                self._tickets = []
                tk.results = ("redo",
                              self.create_transfers_window(tk.evs, tk.tss))
                continue
            results = _window_results(out["r_status"], out["r_ts"], tk.ns,
                                      tk.n_pad)
            if self._wt:
                self._register_window_capture(tk, [st for st, _ in results])
            if tk.deep:
                self.deep_fixpoint_batches += len(tk.evs)
            self.fast_batches += len(tk.evs)
            self._probe_succeeded()
            tk.results = ("ok", results)
        self._maybe_recycle_ring()

    def create_transfers_window(self, evs: list[dict],
                                timestamps: list[int],
                                all_or_nothing: bool = False):
        """K prepares (unpadded SoA dicts) in ONE device dispatch. Returns
        one (status uint32, timestamp uint64) pair a prepare.

        The default route is the chain: each prepare runs against the
        state the earlier ones left, and a prepare that falls back does
        so alone: the clean prefix stays committed, that prepare replays
        per batch (the ladder and the exact path) and the rest re-windows.
        Windows the chain cannot serve take a flat tier, which falls back
        whole with the state untouched, and then run per batch: imported
        windows super_imported, balancing windows super_balancing (their
        own tiers, not counted as deep escalations), windows with closing
        flags, in-window pending references or in the limit-breach
        regime super_deep. all_or_nothing=True (a replica's commit):
        always a flat tier (super, escalating to super_deep when
        limit_only, unless a flag picks the tier), and on a fallback None
        with nothing applied."""
        self.resolve_windows()  # pipeline ordering
        assert len(evs) == len(timestamps) and evs
        if self._part_router is not None:
            # Attach mode: the partitioned state is the ledger.
            assert not all_or_nothing, \
                "attach mode: the replica commit loop is single-chip scope"
            return self._partitioned_window_sync(evs, timestamps)
        ns = [len(e["id_lo"]) for e in evs]
        W = len(evs)
        if W > 1 and not self._mirror_route():
            n_pad = _pad_bucket(max(ns))
            imported = _has_imported(evs)
            balancing = not imported and _has_balancing(evs)
            deep_first = (not imported and not balancing
                          and (self._fixpoint_first or _has_closing(evs)
                               or _evs_pend_refs(evs)))
            if not (imported or balancing or all_or_nothing or deep_first):
                lanes = self._pack("chain", evs, timestamps, n_pad)
                outs = self._dispatch("chain", lanes, n_pad)
                self._count_route("chain")
                out = Harvest(outs, _WINDOW_OUTS).get()
                k, results = self._resolve_chain_prefix(out, ns)
                if self._wt and k:
                    self._capture_window_delta(
                        evs[:k], [st for st, _ in results], timestamps[:k])
                if k == W:
                    return results
                results.append(
                    self.create_transfers_soa(evs[k], timestamps[k]))
                if k + 1 < W:
                    results.extend(self.create_transfers_window(
                        evs[k + 1:], timestamps[k + 1:]))
                return results
            lanes = self._pack("super", evs, timestamps, n_pad)
            if imported or balancing:
                # Their own tiers (a balancing window at the deep window
                # budget); an unconverged balancing window falls back to
                # the per-batch balancing ladder.
                route = "super_imported" if imported else "super_balancing"
                self._count_route(route)
                outs = self._dispatch(route, lanes, n_pad)
            elif deep_first:
                self._count_route("super_deep")
                outs = self._dispatch("super_deep", lanes, n_pad)
                self.deep_fixpoint_batches += W
            else:
                self._count_route("super")
                outs = self._dispatch("super", lanes, n_pad)
                if all(_host_bools(outs["fallback"], outs["limit_only"])):
                    # Limits or in-window pendings were the only
                    # obstacle: the deep window tier resolves them (the
                    # state is untouched).
                    outs = self._dispatch("super_deep", lanes, n_pad)
                    self.deep_fixpoint_batches += W
            out = Harvest(outs, _WINDOW_OUTS).get()
            if not out["fallback"]:
                self.fast_batches += W
                self._probe_succeeded()
                results = _window_results(out["r_status"], out["r_ts"], ns,
                                          n_pad)
                if self._wt:
                    self._capture_window_delta(
                        evs, [st for st, _ in results], timestamps,
                        exact_chunks=all_or_nothing)
                return results
            self.window_fallbacks += 1
            self._note_fb(out)
        if all_or_nothing:
            return None
        self._count_route("per_batch")
        return [self.create_transfers_soa(ev, ts)
                for ev, ts in zip(evs, timestamps)]

    # ------------------------------------------------------------- pulse

    def pulse_needed(self, timestamp: int) -> bool:
        return u64(self.state["pulse_next"]) <= timestamp

    def expire_pending_transfers(self, timestamp: int) -> int:
        """Expiry runs on the exact host path (rare, pulse-driven),
        through the mirror regime like a hard batch."""
        self.resolve_windows()  # pipeline ordering
        self.drain_mirror()
        sm = self.mirror if self.mirror is not None else self._enter_mirror()
        n = sm.expire_pending_transfers(timestamp)
        self._push_dirty()
        return n


def results_to_arrays(results) -> tuple:
    """Result objects -> (status uint32, timestamp uint64) arrays."""
    st = np.fromiter((int(r.status) for r in results), dtype=np.uint32,
                     count=len(results))
    ts = np.fromiter((r.timestamp for r in results), dtype=np.uint64,
                     count=len(results))
    return st, ts


def _transfer_from_row(x, r: int, tid) -> Transfer:
    """A transfer from named row columns; tid None reads the id too."""
    return Transfer(
        id=(u128.to_int(x["id_hi"][r], x["id_lo"][r]) if tid is None
            else tid),
        debit_account_id=u128.to_int(x["dr_hi"][r], x["dr_lo"][r]),
        credit_account_id=u128.to_int(x["cr_hi"][r], x["cr_lo"][r]),
        amount=u128.to_int(x["amt_hi"][r], x["amt_lo"][r]),
        pending_id=u128.to_int(x["pid_hi"][r], x["pid_lo"][r]),
        user_data_128=u128.to_int(x["ud128_hi"][r], x["ud128_lo"][r]),
        user_data_64=int(x["ud64"][r]) & _MASK64,
        user_data_32=int(x["ud32"][r]),
        timeout=int(x["timeout"][r]),
        ledger=int(x["ledger"][r]),
        code=int(x["code"][r]),
        flags=int(x["flags"][r]),
        timestamp=int(x["ts"][r]) & _MASK64,
    )


def warmup_kernels(a_cap: int = 1 << 17, t_cap: int = 1 << 21,
                   device=None) -> float:
    """Build the device engine's CUDA kernels and run them once on a
    throwaway ledger at the serving capacities, so that no client request
    pays for the first `nvcc` build or the first launch (the JAX
    package's warmup compiles its jitted programs the same way). A breach
    batch first (the limit fixpoint tier, before any batch can put the
    throwaway ledger on the host mirror), then a plain and a two-phase
    batch. On the CPU nothing is built. Returns the elapsed seconds."""
    import threading

    from . import _build

    t0 = time.time()
    device = resolve_device(device)
    if device.type == "cuda":
        errors: list = []

        def build(name):
            try:
                _build.build(name)
            except Exception as exc:   # re-raised below
                errors.append(exc)

        threads = [threading.Thread(target=build, args=(name,))
                   for name in ("ht_probe", "row_gather")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
    led = DeviceLedger(a_cap=a_cap, t_cap=t_cap, device=device)
    led.create_accounts(
        [Account(id=1, ledger=1, code=1), Account(id=2, ledger=1, code=1),
         Account(id=3, ledger=1, code=1,
                  flags=int(AccountFlags.debits_must_not_exceed_credits))],
        1_000)
    led.create_transfers(
        [Transfer(id=4, debit_account_id=3, credit_account_id=2, amount=1,
                   ledger=1, code=1)],
        2_000)
    assert led.fixpoint_batches == 1, "breach batch must warm the fixpoint"
    led.create_transfers(
        [Transfer(id=1, debit_account_id=1, credit_account_id=2, amount=1,
                   ledger=1, code=1),
         Transfer(id=2, debit_account_id=1, credit_account_id=2, amount=1,
                   ledger=1, code=1, flags=int(TransferFlags.pending), timeout=3600),
         Transfer(id=3, pending_id=2, amount=1, ledger=1, code=1,
                   flags=int(TransferFlags.post_pending_transfer))],
        3_000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    led.shutdown_staging()
    led.release()
    return time.time() - t0
