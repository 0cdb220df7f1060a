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
escalation, the deep tier first for DEEP_PROBE_INTERVAL batches.

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

Not ported here (later slices; on this path they are absent): the
write-through mirror (`write_through`, `drain_mirror`, the fast-batch
delta capture) and the lazy mirror containers (the oracle's own
containers serve), the window chain (`submit_window`,
`resolve_windows`), and the imported / balancing device tiers — such
batches take the mirror here where the JAX package runs them natively.

The device is explicit: `DeviceLedger(device=None)` means CUDA and
raises when no CUDA device is present; the tests pass `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BATCH_MAX, NS_PER_S
from ..oracle.state_machine import AccountEventRecord, StateMachineOracle
from ..types import (
    Account,
    CreateAccountResult,
    CreateAccountStatus,
    CreateTransferResult,
    CreateTransferStatus,
    Transfer,
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
    EV_NCOLS,
    EV_P32_POS,
    EV_U64_IDX,
    XF_NCOLS,
    XF_P32_POS,
    XF_U64_IDX,
    ac_named,
    bal_col,
    ev_cap,
    ev_named,
    pack32,
    xf_named,
)
from .fast_kernels import (
    create_accounts_fast,
    create_transfers_fast,
    create_transfers_fixpoint,
    create_transfers_fixpoint_deep,
)
from .fused_probe import ht_lookup_fused
from .hash_table import ORPHAN_VAL, SLOTS, ht_init, ht_insert
from .row_gather import row_gather_multi
from .u64 import carrier, s64, u64

N_PAD = 8192
assert N_PAD >= BATCH_MAX

# Padded-shape buckets for the kernels: a batch runs at the smallest
# bucket that fits.
PAD_BUCKETS = (1024, 2048, 4096, N_PAD)

_CTS_BY_CODE = {int(m): m for m in CreateTransferStatus}
_CAS_BY_CODE = {int(m): m for m in CreateAccountStatus}
_MASK64 = (1 << 64) - 1


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


def _pack_transfer_rows(objs, pstat_of, acct_row_of, a_dump):
    """Transfer objects -> one packed uint64 row matrix."""
    n = len(objs)
    u64m = np.zeros((n, XF_NCOLS), dtype=np.uint64)
    w32 = {name: np.zeros(n, dtype=np.int64) for name in XF_P32_POS}
    U = XF_U64_IDX
    for i, o in enumerate(objs):
        u64m[i, U["id_hi"]], u64m[i, U["id_lo"]] = _split(o.id)
        (u64m[i, U["dr_hi"]],
         u64m[i, U["dr_lo"]]) = _split(o.debit_account_id)
        (u64m[i, U["cr_hi"]],
         u64m[i, U["cr_lo"]]) = _split(o.credit_account_id)
        u64m[i, U["amt_hi"]], u64m[i, U["amt_lo"]] = _split(o.amount)
        u64m[i, U["pid_hi"]], u64m[i, U["pid_lo"]] = _split(o.pending_id)
        (u64m[i, U["ud128_hi"]],
         u64m[i, U["ud128_lo"]]) = _split(o.user_data_128)
        u64m[i, U["ud64"]] = o.user_data_64
        u64m[i, U["ts"]] = o.timestamp
        u64m[i, U["expires"]] = (
            o.timestamp + o.timeout * NS_PER_S if o.timeout else 0)
        w32["ud32"][i] = o.user_data_32
        w32["timeout"][i] = o.timeout
        w32["ledger"][i] = o.ledger
        w32["code"][i] = o.code
        w32["flags"][i] = o.flags
        w32["pstat"][i] = pstat_of(o)
        w32["dr_row"][i] = acct_row_of(o.debit_account_id, a_dump)
        w32["cr_row"][i] = acct_row_of(o.credit_account_id, a_dump)
    for name, vals in w32.items():
        _set32(u64m, XF_P32_POS, name, vals)
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


class DeviceLedger:
    """The device ledger state plus the batch entry points."""

    # After this many consecutive batches in the host-mirror regime, the
    # next one probes the device tiers again (hysteresis).
    MIRROR_PROBE_INTERVAL = 8
    # After an 8 -> 32-round escalation, dispatch the deep tier directly
    # for this many breach batches before re-probing the shallow one.
    DEEP_PROBE_INTERVAL = 8

    def __init__(self, a_cap: int = 1 << 17, t_cap: int = 1 << 21,
                 device=None):
        self.device = resolve_device(device)
        self.a_cap = a_cap
        self.t_cap = t_cap
        self.state = init_state(a_cap, t_cap, device=self.device)
        self.fast_batches = 0
        self.fixpoint_batches = 0
        self.deep_fixpoint_batches = 0
        # On-device tier redispatches (plain -> fixpoint, shallow ->
        # deep): resolved without the host.
        self.escalations = 0
        self.fallbacks = 0
        self._deep_first = 0
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
        # state, reused across consecutive hard batches, so each costs an
        # oracle apply and a push of what it dirtied instead of a full
        # state sync both ways.
        self.mirror = None
        self._mirror_batches = 0
        self._probe_pending = False
        # id -> device row of the mirror's objects (set by to_host /
        # from_host, extended by _push_dirty), and the absolute count of
        # the mirror's history rows already on the device.
        self._acct_row: dict[int, int] = {}
        self._xfer_row: dict[int, int] = {}
        self._events_seen_abs = 0

    # ------------------------------------------------------------- fast path

    def create_accounts(self, accounts: list[Account], timestamp: int):
        if self._mirror_route():
            self.fallbacks += 1
            results = self.mirror.create_accounts(accounts, timestamp)
            self._push_dirty()
            return results
        n = len(accounts)
        ev = pad_account_events(accounts_to_arrays(accounts),
                                n_pad=_pad_bucket(n))
        self.state, out = create_accounts_fast(
            self.state, events_to_device(ev, self.device), timestamp, n)
        if bool(out["fallback"]):
            # The state is unchanged: the batch runs on the mirror.
            return self._fallback_accounts(accounts, timestamp)
        self.fast_batches += 1
        self._probe_succeeded()
        st = out["r_status"][:n].cpu().tolist()
        ts = out["r_ts"][:n].cpu().tolist()
        return [CreateAccountResult(timestamp=ts[i],
                                    status=_CAS_BY_CODE[st[i]])
                for i in range(n)]

    def create_transfers(self, transfers: list[Transfer], timestamp: int):
        ev = transfers_to_arrays(transfers)
        return self.create_transfers_arrays(ev, timestamp,
                                            transfers=transfers)

    def create_transfers_soa(self, ev: dict, timestamp: int):
        """SoA events in, (status uint32, timestamp uint64) numpy arrays
        out — no per-event Python."""
        return self.create_transfers_arrays(ev, timestamp, raw=True)

    def _escalate_fixpoint(self, evd, timestamp, n):
        """The 8-round tier reported a cascade deeper than its budget (and
        no other obstacle): rerun on the 32-round tier and enter the
        deep-first regime. Returns (fallback, out) of the deep run."""
        self.state, out = create_transfers_fixpoint_deep(
            self.state, evd, timestamp, n)
        self.deep_fixpoint_batches += 1
        self.escalations += 1
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
        if self._mirror_route():
            self.fallbacks += 1
            if transfers is None:
                transfers = transfers_from_arrays(ev)
            results = self.mirror.create_transfers(transfers, timestamp)
            self._push_dirty()
            return results_to_arrays(results) if raw else results
        n = len(ev["id_lo"])
        evd = events_to_device(
            pad_transfer_events(ev, n_pad=_pad_bucket(n)), self.device)
        if self._fixpoint_first:
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
        sm.account_events = self._events_to_host(acc, xfr)
        self._events_seen_abs = sm.events_base + len(sm.account_events)
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
        insert sequence (ids in row order, then the orphans sorted)."""
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
        self._events_seen_abs = sm.events_base + n_e
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
        if self.mirror is None:
            return False
        self._mirror_batches += 1
        if self._mirror_batches > self.MIRROR_PROBE_INTERVAL:
            self._probe_pending = True
            return False
        return True

    def _probe_succeeded(self) -> None:
        """A device tier took a batch: a held mirror is stale now (the
        tier changed the device state), so it is dropped."""
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
        (off by default: nothing else would clear it)."""
        for c in (sm.accounts, sm.transfers, sm.pending_status, sm.expiry,
                  sm.orphaned):
            c.track_dev = True
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
        if self._probe_pending:
            self._probe_pending = False
            self._mirror_batches = 1  # the probe failed: the regime goes on
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
        self._events_seen_abs += len(new_events)

        self._set_scalars(sm)

    # ------------------------------------------------------------- pulse

    def pulse_needed(self, timestamp: int) -> bool:
        return u64(self.state["pulse_next"]) <= timestamp

    def expire_pending_transfers(self, timestamp: int) -> int:
        """Expiry runs on the exact host path (rare, pulse-driven),
        through the mirror regime like a hard batch."""
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
