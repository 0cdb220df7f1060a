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
escalation, the deep tier first for DEEP_PROBE_INTERVAL batches. A
batch that still falls back leaves the state untouched and raises
`DeviceTierFallback`: the exact host path is a later slice of the port.
A fallback is never swallowed.

The device is explicit: `DeviceLedger(device=None)` means CUDA and
raises when no CUDA device is present; the tests pass `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BATCH_MAX, NS_PER_S
from ..types import (
    Account,
    CreateAccountResult,
    CreateAccountStatus,
    CreateTransferResult,
    CreateTransferStatus,
    Transfer,
)
from . import u128
from .batch import accounts_to_arrays, transfers_to_arrays
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
    xf_named,
)
from .fast_kernels import (
    create_accounts_fast,
    create_transfers_fast,
    create_transfers_fixpoint,
    create_transfers_fixpoint_deep,
)
from .fused_probe import ht_lookup_fused
from .hash_table import ht_init
from .row_gather import row_gather_multi

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
    out = {}
    for k, v in ev.items():
        v = np.asarray(v)
        if v.dtype == np.bool_:
            t = torch.from_numpy(v)
        elif v.dtype == np.uint64:
            t = torch.from_numpy(v.view(np.int64))
        else:
            t = torch.from_numpy(v.astype(np.int64))
        out[k] = t.to(device)
    return out


class DeviceTierFallback(RuntimeError):
    """No device tier could run a batch: the plain tier's proofs failed
    and the fixpoint tiers (where the causes allowed them) fell back too.
    The state is unchanged. `fb_causes` names the causes reported by the
    last tier that ran; `limit_only` is that tier's escalation flag."""

    def __init__(self, op: str, fb_causes: dict, limit_only: bool):
        self.fb_causes = fb_causes
        self.limit_only = limit_only
        causes = sorted(k for k, v in fb_causes.items() if v)
        super().__init__(
            f"{op}: device-tier fallback (causes: {', '.join(causes)}; "
            f"limit_only={limit_only}); the exact host path is a later "
            "slice of the port")


def _host_bools(*flags) -> list:
    """Scalar device flags -> Python bools in one host sync."""
    return [bool(x) for x in torch.stack(flags).tolist()]


class DeviceLedger:
    """The device ledger state plus the batch entry points."""

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

    def _raise_fallback(self, op: str, out) -> None:
        self.fallbacks += 1
        causes = {k: bool(v) for k, v in out["fb_causes"].items()} \
            if "fb_causes" in out else {}
        raise DeviceTierFallback(op, causes,
                                 bool(out.get("limit_only", False)))

    # ------------------------------------------------------------- fast path

    def create_accounts(self, accounts: list[Account], timestamp: int):
        n = len(accounts)
        ev = pad_account_events(accounts_to_arrays(accounts),
                                n_pad=_pad_bucket(n))
        self.state, out = create_accounts_fast(
            self.state, events_to_device(ev, self.device), timestamp, n)
        if bool(out["fallback"]):
            self._raise_fallback("create_accounts", out)
        self.fast_batches += 1
        st = out["r_status"][:n].cpu().tolist()
        ts = out["r_ts"][:n].cpu().tolist()
        return [CreateAccountResult(timestamp=ts[i],
                                    status=_CAS_BY_CODE[st[i]])
                for i in range(n)]

    def create_transfers(self, transfers: list[Transfer], timestamp: int):
        ev = transfers_to_arrays(transfers)
        return self.create_transfers_arrays(ev, timestamp)

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
                                raw: bool = False):
        """ev: unpadded host SoA dict. The tier ladder reads its flags
        with one host sync per tier run (the JAX package's device_gets);
        the results then come back in one copy each. A tier that falls
        back left the state and the events untouched, so the next tier
        reruns the same batch."""
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
            self._raise_fallback("create_transfers", out)
        self.fast_batches += 1
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


def _transfer_from_row(x, r: int, tid: int) -> Transfer:
    return Transfer(
        id=tid,
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
