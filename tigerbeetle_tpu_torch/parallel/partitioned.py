"""Partitioned ledger state: account-hash sharding with an event exchange
and owner-masked write-back, over the port's in-process mesh.

A port of the JAX package's `parallel/partitioned.py`. The replicated
route (`full_sharded.py`) keeps the whole ledger on every device; here
every store (accounts, transfer rows, the two hash tables, the event
ring) is sharded by the id hash (`shard_utils.shard_of_id`), so each
shard holds ~1/n_shards of the state.

The state is a tuple of per-shard state dicts, `init_state`-shaped at the
per-shard caps, shard s on `mesh.devices[s]` (one device may carry
several shards, `shard_utils.Mesh`). One prepare runs five steps
(`_partitioned_batch_body`):

  1. PROBE + EXCHANGE (transfers): every shard looks up the batch's
     transfer ids and pending ids in its own table and contributes
     (encoded hit, masked row) lanes to one `psum`. Each key lives on
     exactly one shard, so the sum is a select: afterwards every distinct
     device holds the global lookup result and the owner's row.
  2. PROBE + EXCHANGE (accounts): the same for the 4N account keys the
     batch can touch (ev.dr, ev.cr, the pending rows' dr / cr), carrying
     the packed account row and the balance limbs.
  3. ASSEMBLE: the exchanged rows are deduplicated (first occurrence over
     the 128-bit keys, `_uniq_rows`) into a mini-state of O(batch) caps
     with its own small hash tables and mini-local row pointers.
  4. JUDGE: the port's unmodified `per_event_status` and
     `create_transfers_fast(per_event=...)` on the mini-state, once a
     distinct device (as `full_sharded`'s tail is): it sees exactly the
     rows it would have gathered from the full store.
  5. WRITE-BACK: each shard applies the mini's changes to the rows it
     owns: appended transfer and ring rows at its counts, pending-status
     flips in its rows, touched accounts' rows, the new ids in its table.
     Every write is masked by a combined ok (the judge's fallback, a
     shard's capacity, the exchange's), so a failed batch leaves every
     shard's rows below its counts and its scalars as they were.

Two dispatch forms share the body: the per-batch step
(`make_partitioned_create_transfers`, the escalation and replay unit) and
the chain (`make_partitioned_chain_create_transfers`): the W prepares of
a window in one call, a rolling poison flag threaded from prepare k's
fallback into prepare k + 1. The chain reads no device value on the
host, so on the card the ledger's attach mode (`ops/ledger.py`) runs it
as one captured CUDA graph (`ops/window_graph.py`).

The body's row reads go through the row-gather kernel
(`ops/row_gather.py`): the exchange reads each shard's transfer rows (one
launch a shard) and its account and balance rows (one launch a shard,
two tables), and the write-back reads the judged mini's transfer,
account, balance and ring rows (one launch a distinct device, four
tables). The judge runs the fused probe and its own gathers. The
shard-local key probes stay the plain `hash_table.ht_lookup`, as in the
JAX package.

Per-shard tensors are updated in place (`copy_`, `index_put_`): reads
of a shard's counts and rows are ordered before its writes, and the
mini's scalars are copies, so the judge never writes a shard. Masked
lanes scatter to the dump rows, and which of them wins is not fixed on
CUDA: the dump rows lie outside every count, so nothing reads them as
state (the mini's are zeroed after the scatter, as the judge reads
them).

Non-canonical columns: transfer `dr_row` / `cr_row` and the ring's row
pointers are shard-local (or mini-local on the ring), as in the JAX
package; the state digest excludes them.

On a mesh of several processes (`parallel/multihost.py`) the state holds
this process's shards only (`mesh.local`): the body's loops run over
them, `psum` and the gathered per-shard stats (`shard_utils.all_gather`)
go across the processes, and the chain runs eagerly (a gloo collective
cannot be captured in a CUDA graph).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.ev_layout import (AC_NCOLS, EV_NCOLS, EV_P32_POS, XF_NCOLS,
                             XF_P32_POS, XF_U64_IDX, pack32)
from ..ops.fast_kernels import (_CREATED, _TRANSIENT_CODES, _cumsum,
                                create_transfers_fast, imported_batch_ctx,
                                per_event_status)
from ..ops.hash_table import (ORPHAN_VAL, ht_init, ht_insert, ht_lookup,
                              ht_plan, ht_write)
from ..ops.ledger import (_LANES, N_PAD, _delta_gather_body, _pad_bucket,
                          fill_window, pad_transfer_events, unpack_window)
from ..ops.row_gather import row_gather, row_gather_multi
from ..ops.u64 import U64_MAX, _flip, carrier, s64
from ..trace import Event, FlightRecorder, Histogram, NullTracer
from .full_sharded import MODES, _MODE_KWARGS, ShardedRouter
from .shard_utils import (Mesh, OwnershipTable, all_gather, owner_read,
                          owner_read_int, psum, shard_of_id, writes_here)

__all__ = ["make_partitioned_create_transfers",
           "make_partitioned_chain_create_transfers",
           "stack_partitioned_window", "partitioned_from_oracle",
           "partitioned_state_bytes", "replicated_state_bytes",
           "PartitionedRouter", "MODES", "TEL_WORDS", "TEL_LAYOUT",
           "TEL_CAUSES", "decode_telemetry"]

_XF_DRROW_COL = XF_P32_POS["dr_row"][0]   # the (dr_row, cr_row) word
_XF_PSTAT_COL = XF_P32_POS["pstat"][0]    # pstat lives alone (flips)
_EV_PROW_COL = EV_P32_POS["p_row"][0]     # the (pstat, p_row) word
_EV_TFLAGS_COL = EV_P32_POS["tflags"][0]  # the (tflags, dr_flags) word


def _uniq_rows(k_hi, k_lo, active):
    """First-occurrence dedupe of 128-bit keys over the exchange lanes.

    Returns (first: bool[N], the one lane a distinct active key that
    builds the mini row; row: int32[N], that key's dense mini row on
    every lane carrying it, -1 on inactive lanes; n: int32, the distinct
    active keys). Inactive lanes carry the max key 2^128 - 1 (never a
    valid id), which must sort last: the keys sort in unsigned order
    (`_flip`; as an int64 carrier u64::MAX is -1 and would sort first).
    torch has no lexsort, so two stable sorts: by the low half, then by
    the high half."""
    n = k_hi.shape[0]
    dev = k_hi.device
    kh = torch.where(active, k_hi, U64_MAX)
    kl = torch.where(active, k_lo, U64_MAX)
    p_lo = torch.argsort(_flip(kl), stable=True)
    p_hi = torch.argsort(_flip(kh)[p_lo], stable=True)
    perm = p_lo[p_hi]
    khs, kls = kh[perm], kl[perm]
    first_s = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (khs[1:] != khs[:-1]) | (kls[1:] != kls[:-1])])
    act_s = active[perm]
    run = _cumsum(first_s.to(torch.int32)) - 1
    first_act = first_s & act_s
    n_uniq = first_act.sum().to(torch.int32)
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[perm] = first_act
    row = torch.zeros(n, dtype=torch.int32, device=dev)
    row[perm] = run.to(torch.int32)
    return first, torch.where(active, row, -1), n_uniq


# ------------------------------------------------------- telemetry plane
#
# A fixed-layout u32 block a (shard, prepare), built from values the body
# computes anyway. Words 0-6 and 10 are replicated (equal on every shard:
# they summarize the mini judgment and the exchange); words 7-9 and 11
# are per shard.
TEL_LAYOUT = (
    "fix_rounds",            # 0  fixpoint rounds consumed (0 = plain)
    "poison_cause",          # 1  priority-encoded cause, 0 = clean
    "xchg1_occupancy",       # 2  live transfer rows in the 2N phase-1 lanes
    "xchg1_capacity",        # 3  phase-1 lane capacity (2N)
    "xchg2_occupancy",       # 4  distinct account keys in the 4N lanes
    "xchg2_capacity",        # 5  phase-2 mini capacity (4N)
    "cross_shard_transfers",  # 6  created transfers whose dr/cr shards differ
    "ring_occupancy",        # 7  event-ring rows after write-back (per shard)
    "writeback_transfers",   # 8  owner-masked rows written (per shard)
    "events_owned",          # 9  valid events routed to this shard
    "exchange_overflow",     # 10 0/1: a phase capacity breached
    "shard_capacity_hit",    # 11 0/1: this shard's store/ring/plan capacity
)
TEL_WORDS = len(TEL_LAYOUT)

# poison_cause codes: index + 1 into this tuple; the earliest listed cause
# that fired wins (a forced poison shows only when no intrinsic cause
# explains the prepare): out["fb_causes"] plus the exchange's breaches.
TEL_CAUSES = (
    "e1_hard_flags", "e2_collision", "e3_limit", "e4_overflow",
    "e5_void_closing", "closing", "capacity", "forced",
    "shard_capacity", "exchange_overflow",
)


def _telemetry_block(out, fbc, *, n_lanes, n_a, n_live, xchg_bad, bad_l,
                     cross_shard, ring_count, n_mine_ok, owned):
    """One shard's telemetry vector (int64 carrying u32 words), from the
    body's intermediates; constants are made by fills, so a capture
    holds."""
    dev = n_a.device
    cause = torch.zeros((), dtype=torch.int64, device=dev)
    for i, name in reversed(list(enumerate(TEL_CAUSES, start=1))):
        cause = torch.where(fbc[name], i, cause)

    def const(v):
        return torch.full((), v, dtype=torch.int64, device=dev)

    return _telemetry_pack(
        out["fix_rounds"], cause, n_live, const(2 * n_lanes), n_a,
        const(4 * n_lanes), cross_shard, ring_count, n_mine_ok, owned,
        xchg_bad, bad_l, device=dev)


# The telemetry pack's census hook: None but while torchhound's census
# runs a call (`torchhound/core.py` `trace`), which then sees each pack's
# words and the aten ops inside it (`telemetry_census`). It changes
# nothing the pack computes.
PACK_HOOK = None


def _telemetry_pack(*words, device):
    """Pack the telemetry words into one int64 vector on `device`: the
    named pack torchhound's telemetry census finds (the JAX package's
    named `_telemetry_pack` jit)."""
    if PACK_HOOK is not None:
        return PACK_HOOK(_pack_words, words, device)
    return _pack_words(words, device)


def _pack_words(words, device):
    return torch.stack([w.to(device=device, dtype=torch.int64)
                        for w in words])


def decode_telemetry(tel) -> dict:
    """Host-side decode: [..., TEL_WORDS] words -> {name: int array}. The
    leading axes are whatever the harvest kept (shard, or shard x W for
    the chain)."""
    arr = np.asarray(_np(tel)).astype(np.uint32)
    assert arr.shape[-1] == TEL_WORDS, arr.shape
    return {name: arr[..., i].astype(np.int64)
            for i, name in enumerate(TEL_LAYOUT)}


def _np(x):
    """A tensor (any device) or an array -> a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ------------------------------------------------------------ the body

def _owner(k_hi, k_lo, n_dev: int, overlay: tuple):
    return (owner_read(k_hi, k_lo, n_dev, overlay) if overlay
            else shard_of_id(k_hi, k_lo, n_dev))


def _partitioned_batch_body(mesh: Mesh, subs, evs: dict, segs: dict, *,
                            mode: str, force_fallback=None,
                            telemetry: bool = True, overlay: tuple = ()):
    """One prepare against the per-shard states `subs` (updated in
    place): the exchange -> mini-state -> judge -> write-back of the
    module note, shared by the per-batch step and each prepare of the
    chain.

    `evs` / `segs`: {distinct device: the padded batch's event tensors /
    its one-prepare seg (ts_event, seg_start, chain_term)}, replicated.
    `force_fallback`: None or {distinct device: bool tensor}, the chain's
    rolling poison: the judge aborts, the masked write-back leaves every
    shard as it was, and the poison rides out through rep["fallback"].
    `overlay`: the elastic-shards ownership entries
    (`OwnershipTable.entries`); with a non-empty overlay every probe
    contribution is masked by read ownership and every write-back mask
    is `writes_here`; an empty one takes the plain paths.

    On a multi-process mesh `subs` are this process's shards (global
    indexes `mesh.local`): the loops run over them, and the sums go
    across the processes (`psum`).

    Returns (reps, owned, tels): {distinct device: the amended out dict},
    the local shards' routed-event counts (int32, on each shard's device)
    and their telemetry vectors (None without `telemetry`)."""
    devs = mesh.devices
    n_dev = mesh.size
    shards = tuple(zip(mesh.local, subs))
    # The local position (into subs) of each distinct device's first
    # shard.
    first_shard = {d: devs.index(d) for d in mesh.distinct}
    ev0 = evs[mesh.distinct[0]]
    N = ev0["id_lo"].shape[0]
    MA, MT, ME = 4 * N, 3 * N, N

    # ---- phase 1: transfer-key probe + exchange (2N lanes: [ev.id |
    # ev.pid]). Lane 0 of the exchanged row: 0 absent, 1 orphan (a stored
    # ORPHAN_VAL reads as val -1), r + 2 the owner's live row r.
    L = {}
    for d in mesh.distinct:
        ev = evs[d]
        L[d] = dict(xk_hi=torch.cat([ev["id_hi"], ev["pid_hi"]]),
                    xk_lo=torch.cat([ev["id_lo"], ev["pid_lo"]]))
    x_parts, x_probe = [], []
    for i, (s, sub) in enumerate(shards):
        l_ = L[devs[i]]
        xfr = sub["transfers"]
        t_dump = xfr["u64"].shape[0] - 1
        xf_raw, xv = ht_lookup(sub["xfer_ht"], l_["xk_hi"], l_["xk_lo"])
        if overlay:
            # Mid-migration a range's rows exist on both owners: only the
            # read owner's copy may feed the sum.
            read_mine = owner_read(l_["xk_hi"], l_["xk_lo"], n_dev,
                                   overlay) == s
            xf = xf_raw & read_mine
        else:
            read_mine = None
            xf = xf_raw
        live = xf & (xv >= 0)
        enc = torch.where(xf, xv.to(torch.int64) + 2, 0)
        xrow = torch.where(live, xv, t_dump)
        xdata = torch.where(live[:, None], row_gather(xfr["u64"], xrow), 0)
        x_parts.append(torch.cat([enc[:, None], xdata], dim=1))
        x_probe.append((xf_raw, xv, read_mine))
    g_x = dict(zip(mesh.distinct, psum(mesh, x_parts)))
    del x_parts

    # ---- phase 2: account-key probe + exchange (4N lanes: [ev.dr | ev.cr
    # | p.dr | p.cr], the pendings' account ids off phase 1). 0 absent,
    # r + 1 the owner's row r; zero keys (padding, absent pendings) hit
    # the table's empty sentinel.
    for d in mesh.distinct:
        ev, l_ = evs[d], L[d]
        g = g_x[d]
        l_["g_enc"] = g[:, 0]
        l_["g_rows"] = g[:, 1:]
        p_rows = l_["g_rows"][N:]
        l_["x_active"] = l_["g_enc"] > 0
        l_["x_live"] = l_["g_enc"] >= 2
        l_["ak_hi"] = torch.cat([ev["dr_hi"], ev["cr_hi"],
                                 p_rows[:, XF_U64_IDX["dr_hi"]],
                                 p_rows[:, XF_U64_IDX["cr_hi"]]])
        l_["ak_lo"] = torch.cat([ev["dr_lo"], ev["cr_lo"],
                                 p_rows[:, XF_U64_IDX["dr_lo"]],
                                 p_rows[:, XF_U64_IDX["cr_lo"]]])
    a_parts, a_probe = [], []
    for i, (s, sub) in enumerate(shards):
        l_ = L[devs[i]]
        acc = sub["accounts"]
        a_dump = acc["u64"].shape[0] - 1
        af_raw, ar = ht_lookup(sub["acct_ht"], l_["ak_hi"], l_["ak_lo"])
        if overlay:
            read_mine = owner_read(l_["ak_hi"], l_["ak_lo"], n_dev,
                                   overlay) == s
            af = af_raw & read_mine
        else:
            read_mine = None
            af = af_raw
        aenc = torch.where(af, ar.to(torch.int64) + 1, 0)
        arow = torch.where(af, ar, a_dump)
        au, ab = row_gather_multi((acc["u64"], acc["bal"]), arow)
        au = torch.where(af[:, None], au, 0)
        ab = torch.where(af[:, None], ab, 0)
        a_parts.append(torch.cat([aenc[:, None], au, ab], dim=1))
        a_probe.append((af_raw, ar, read_mine))
    g_a = dict(zip(mesh.distinct, psum(mesh, a_parts)))
    del a_parts

    # ---- assemble the mini-state (O(batch) caps), once a distinct
    # device.
    for d in mesh.distinct:
        l_ = L[d]
        ga = g_a[d]
        l_["g_aenc"] = ga[:, 0]
        g_au = ga[:, 1:1 + AC_NCOLS]
        g_ab = ga[:, 1 + AC_NCOLS:]
        a_active = l_["g_aenc"] > 0
        afirst, amrow, n_a = _uniq_rows(l_["ak_hi"], l_["ak_lo"], a_active)
        dst_a = torch.where(afirst, amrow, MA)
        mini_au = torch.zeros((MA + 1, AC_NCOLS), dtype=torch.int64,
                              device=d)
        mini_au[dst_a] = g_au
        mini_au[MA] = 0
        mini_ab = torch.zeros((MA + 1, 16), dtype=torch.int64, device=d)
        mini_ab[dst_a] = g_ab
        mini_ab[MA] = 0
        ht_a, ok_a = ht_insert(ht_init(8 * N, d), l_["ak_hi"], l_["ak_lo"],
                               amrow, afirst)

        xfirst, _, _ = _uniq_rows(l_["xk_hi"], l_["xk_lo"], l_["x_active"])
        lfirst, lrow, n_live = _uniq_rows(l_["xk_hi"], l_["xk_lo"],
                                          l_["x_live"])
        mini_xu = torch.zeros((MT + 1, XF_NCOLS), dtype=torch.int64,
                              device=d)
        mini_xu[torch.where(lfirst, lrow, MT)] = l_["g_rows"]
        mini_xu[MT] = 0
        # Mini-local row pointers: each exchanged row's (dr_row, cr_row)
        # word from its own id columns through the mini account table
        # (absent -> the mini dump row). Only the pending rows' pointers
        # are dereferenced, and their dr / cr are phase-2 keys.
        m_hi = torch.cat([mini_xu[:, XF_U64_IDX["dr_hi"]],
                          mini_xu[:, XF_U64_IDX["cr_hi"]]])
        m_lo = torch.cat([mini_xu[:, XF_U64_IDX["dr_lo"]],
                          mini_xu[:, XF_U64_IDX["cr_lo"]]])
        fm, rm = ht_lookup(ht_a, m_hi, m_lo)
        rm = torch.where(fm, rm, MA).to(torch.int64)
        has_ids = (m_hi[:MT + 1] | m_lo[:MT + 1]) != 0
        mini_xu[:, _XF_DRROW_COL] = torch.where(
            has_ids, pack32(rm[:MT + 1], rm[MT + 1:]),
            mini_xu[:, _XF_DRROW_COL])
        ht_x, ok_x = ht_insert(ht_init(8 * N, d), l_["xk_hi"], l_["xk_lo"],
                               torch.where(l_["x_live"], lrow, ORPHAN_VAL),
                               xfirst)
        l_["xchg_bad"] = ((~ok_a) | (~ok_x) | (n_a > MA)
                          | (n_live > 2 * N))
        # The ring's prefill (p_row -1, tflags 0xFFFFFFFF) by column fills.
        mini_ev = torch.zeros((ME + 1, EV_NCOLS), dtype=torch.int64,
                              device=d)
        mini_ev[:, _EV_PROW_COL] = s64(0xFFFFFFFF << 32)
        mini_ev[:, _EV_TFLAGS_COL] = 0xFFFFFFFF
        sub0 = subs[first_shard[d]]
        # Counts and scalars are copies: the judge writes its state in
        # place, and n_live / n_a are read again after it.
        l_["mini"] = dict(
            accounts=dict(u64=mini_au, bal=mini_ab, count=n_a.clone()),
            transfers=dict(u64=mini_xu, count=n_live.clone()),
            events=dict(u64=mini_ev,
                        count=torch.zeros((), dtype=torch.int32, device=d)),
            acct_ht=ht_a,
            xfer_ht=ht_x,
            # Scalars are stored per shard but hold global values.
            acct_key_max=sub0["acct_key_max"].clone(),
            xfer_key_max=sub0["xfer_key_max"].clone(),
            pulse_next=sub0["pulse_next"].clone(),
            commit_ts=sub0["commit_ts"].clone(),
        )
        l_.update(afirst=afirst, amrow=amrow, n_a=n_a, lfirst=lfirst,
                  lrow=lrow, n_live=n_live)

    # ---- judge: the unmodified single-chip tier on the mini-state, once
    # a distinct device. The imported tier's account-timestamp collision
    # is the one batch-context piece that needs the full table: each
    # shard searches its own column and the memberships sum over the mesh.
    ictx = {d: None for d in mesh.distinct}
    if mode == "imported":
        ctxs, colls = [], []
        for i, sub in enumerate(subs):
            d = devs[i]
            ev = evs[d]
            ctx = imported_batch_ctx(
                sub, ev, segs[d]["ts_event"], ev["valid"],
                torch.arange(N, dtype=torch.int64, device=d))
            ctxs.append(ctx)
            colls.append(ctx["acct_ts_collision"])
        total = dict(zip(mesh.distinct, psum(mesh, colls)))
        for d in mesh.distinct:
            ictx[d] = dict(ctxs[first_shard[d]],
                           acct_ts_collision=total[d] > 0)
    for d in mesh.distinct:
        ev, l_ = evs[d], L[d]
        mini = l_["mini"]
        pe = per_event_status(mini, ev, segs[d]["ts_event"],
                              imported_ctx=ictx[d])
        pe.pop("_gathers")
        kw = dict(_MODE_KWARGS[mode])
        if force_fallback is not None:
            kw["force_fallback"] = force_fallback[d]
        _, out = create_transfers_fast(mini, ev, 0, 0, per_event=pe,
                                       seg=segs[d], **kw)
        l_["out"] = out
        status = out["r_status"]
        created = ev["valid"] & (status == _CREATED)
        transient = torch.zeros_like(created)
        for code in _TRANSIENT_CODES:
            transient = transient | (status == code)
        l_["created"] = created
        l_["ins_mask"] = created | (ev["valid"] & transient)
        l_["owner_ev"] = _owner(ev["id_hi"], ev["id_lo"], n_dev, overlay)
        # The judged mini's rows the write-back stores, in one launch:
        # appended transfer rows, touched account rows and balances, ring
        # rows.
        mini_t0 = l_["n_live"]
        row_off = _cumsum(created.to(torch.int64)) - created.to(torch.int64)
        l_["row_off"] = row_off
        mini_trow = torch.clamp(mini_t0 + row_off, 0, MT)
        amrow_c = torch.where(l_["afirst"], l_["amrow"], MA)
        (l_["new_rows"], l_["new_au"], l_["new_ab"],
         l_["ring_rows"]) = row_gather_multi(
            (mini["transfers"]["u64"], mini["accounts"]["u64"],
             mini["accounts"]["bal"], mini["events"]["u64"]),
            (mini_trow, amrow_c, amrow_c, torch.clamp(row_off, 0, ME)))
        l_["pword"] = mini["transfers"]["u64"][:, _XF_PSTAT_COL][
            torch.where(l_["x_live"], l_["lrow"], MT)]

    # ---- per-shard write-back plan and the combined ok.
    plans, bads = [], []
    for i, (s, sub) in enumerate(shards):
        d = devs[i]
        ev, l_ = evs[d], L[d]
        xfr, evr = sub["transfers"], sub["events"]
        if overlay:
            wr_ev = writes_here(ev["id_hi"], ev["id_lo"], n_dev, s, overlay)
        else:
            wr_ev = l_["owner_ev"] == s
        mine = l_["created"] & wr_ev
        ins_mine = l_["ins_mask"] & wr_ev
        mine64 = mine.to(torch.int64)
        n_mine = mine64.sum().to(torch.int32)
        local_rank = _cumsum(mine64) - mine64
        pos, ok_pl = ht_plan(sub["xfer_ht"], ev["id_hi"], ev["id_lo"],
                             ins_mine)
        bad_l = ((xfr["count"] + n_mine > xfr["u64"].shape[0] - 1)
                 | (evr["count"] + n_mine > evr["u64"].shape[0] - 1)
                 | ~ok_pl)
        plans.append((mine, ins_mine, n_mine, local_rank, pos))
        bads.append(bad_l)
    bad_sum = dict(zip(mesh.distinct, psum(mesh, bads)))
    for d in mesh.distinct:
        l_ = L[d]
        l_["bad"] = bad_sum[d] > 0
        l_["g_ok"] = ((~l_["out"]["fallback"]) & (~l_["bad"])
                      & (~l_["xchg_bad"]))

    # ---- write-back: every write masked by g_ok (the dump rows absorb
    # masked lanes). Each shard's counts are read before they move.
    owned, tels = [], []
    reps = {}
    for d in mesh.distinct:
        ev, l_ = evs[d], L[d]
        out = l_["out"]
        xb = l_["bad"] | l_["xchg_bad"]
        rep = dict(out)
        rep["r_status"] = torch.where(xb, 0, out["r_status"])
        rep["r_ts"] = torch.where(xb, 0, out["r_ts"])
        rep["fallback"] = out["fallback"] | xb
        rep["limit_only"] = out["limit_only"] & ~xb
        rep["created_count"] = torch.where(xb, 0, out["created_count"])
        fbc = dict(out["fb_causes"])
        fbc["shard_capacity"] = l_["bad"]
        fbc["exchange_overflow"] = l_["xchg_bad"]
        rep["fb_causes"] = fbc
        # The durable flush rides the mini: the appended rows and the
        # id / p_ts derivations, mini-resolved.
        rep["flush"] = _delta_gather_body(l_["mini"], l_["n_live"], 0, N, N)
        owner_dr = _owner(ev["dr_hi"], ev["dr_lo"], n_dev, overlay)
        owner_cr = _owner(ev["cr_hi"], ev["cr_lo"], n_dev, overlay)
        rep["cross_shard_transfers"] = (
            l_["created"] & (owner_dr != owner_cr)).sum().to(torch.int32)
        rep["exchange_overflow"] = l_["xchg_bad"]
        l_["fbc"] = fbc
        if not overlay:
            l_["owner_xk"] = shard_of_id(l_["xk_hi"], l_["xk_lo"], n_dev)
            l_["owner_ak"] = shard_of_id(l_["ak_hi"], l_["ak_lo"], n_dev)
        reps[d] = rep
    for i, (s, sub) in enumerate(shards):
        d = devs[i]
        ev, l_ = evs[d], L[d]
        g_ok = l_["g_ok"]
        acc, xfr, evr = sub["accounts"], sub["transfers"], sub["events"]
        a_dump = acc["u64"].shape[0] - 1
        t_dump = xfr["u64"].shape[0] - 1
        e_dump = evr["u64"].shape[0] - 1
        mine, ins_mine, n_mine, local_rank, pos = plans[i]
        t_count = xfr["count"].to(torch.int64)
        e_count = evr["count"].to(torch.int64)
        dest_t = torch.where(mine & g_ok, t_count + local_rank, t_dump)
        dest_e = torch.where(mine & g_ok, e_count + local_rank, e_dump)
        vals = torch.where(l_["created"], t_count + local_rank, ORPHAN_VAL)
        # Stored row pointers are shard-local: the new rows' dr / cr
        # resolve against this shard's table (remote -> the dump row).
        f2, r2 = ht_lookup(sub["acct_ht"],
                           torch.cat([ev["dr_hi"], ev["cr_hi"]]),
                           torch.cat([ev["dr_lo"], ev["cr_lo"]]))
        r2 = torch.where(f2, r2, a_dump).to(torch.int64)
        rows = l_["new_rows"].clone()
        rows[:, _XF_DRROW_COL] = pack32(r2[:N], r2[N:])
        # Pending-status flips on existing owned rows: the pstat word is
        # alone in its column; unchanged rows rewrite their own value.
        xf_raw, xv, read_mine_x = x_probe[i]
        if overlay:
            # Copy-catchup owners flip their own copy's row: the read
            # owner's row is the exchanged encoding, the other write
            # owner's its own lookup (absent here -> the dump row).
            wr_xk = writes_here(l_["xk_hi"], l_["xk_lo"], n_dev, s, overlay)
            flip = l_["lfirst"] & wr_xk
            row_here = torch.where(read_mine_x, l_["g_enc"] - 2,
                                   xv.to(torch.int64))
            has_here = read_mine_x | (xf_raw & (xv >= 0))
            dest_p = torch.where(flip & g_ok & has_here, row_here, t_dump)
            af_raw, ar, read_mine_a = a_probe[i]
            wr_ak = writes_here(l_["ak_hi"], l_["ak_lo"], n_dev, s, overlay)
            wb_a = l_["afirst"] & wr_ak
            arow_here = torch.where(read_mine_a, l_["g_aenc"] - 1,
                                    ar.to(torch.int64))
            dest_a = torch.where(wb_a & g_ok & (read_mine_a | af_raw),
                                 arow_here, a_dump)
        else:
            flip = l_["lfirst"] & (l_["owner_xk"] == s)
            dest_p = torch.where(flip & g_ok, l_["g_enc"] - 2, t_dump)
            wb_a = l_["afirst"] & (l_["owner_ak"] == s)
            dest_a = torch.where(wb_a & g_ok, l_["g_aenc"] - 1, a_dump)
        n_mine_ok = torch.where(g_ok, n_mine, 0).to(torch.int32)
        ring_count = evr["count"] + n_mine_ok
        bad_l = bads[i]
        # Writes, after every read above.
        xfr["u64"][dest_t] = rows
        xfr["u64"][dest_p, _XF_PSTAT_COL] = l_["pword"]
        acc["u64"][dest_a] = l_["new_au"]
        acc["bal"][dest_a] = l_["new_ab"]
        evr["u64"][dest_e] = l_["ring_rows"]
        ht_write(sub["xfer_ht"], pos, ev["id_hi"], ev["id_lo"], vals,
                 ins_mine & g_ok)
        xfr["count"].copy_(xfr["count"] + n_mine_ok)
        evr["count"].copy_(ring_count)
        mini = l_["mini"]
        for k in ("acct_key_max", "xfer_key_max", "pulse_next", "commit_ts"):
            sub[k].copy_(torch.where(g_ok, mini[k], sub[k]))
        own = (ev["valid"] & (l_["owner_ev"] == s)).sum().to(torch.int32)
        owned.append(own)
        if telemetry:
            tels.append(_telemetry_block(
                l_["out"], l_["fbc"], n_lanes=N, n_a=l_["n_a"],
                n_live=l_["n_live"], xchg_bad=l_["xchg_bad"], bad_l=bad_l,
                cross_shard=reps[d]["cross_shard_transfers"],
                ring_count=ring_count, n_mine_ok=n_mine_ok, owned=own))
    return reps, owned, (tels if telemetry else None)


# ------------------------------------------------------------ the steps

def _ev_on(ev: dict, device) -> dict:
    """A padded event dict (host numpy in the JAX package's dtypes, or
    carrier tensors) -> carrier tensors on `device`."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else carrier(v, device)) for k, v in ev.items()}


def _one_seg(N: int, ts_first, n, device) -> dict:
    """One prepare's seg lanes: ts_event = ts_first + i, its first lane,
    its last valid lane (n - 1). `ts_first` and `n` are device scalars or
    Python ints."""
    idxs = torch.arange(N, dtype=torch.int64, device=device)
    return dict(ts_event=idxs + ts_first, seg_start=idxs == 0,
                chain_term=idxs == (n - 1))


def _gather_shards(mesh: Mesh, parts) -> torch.Tensor:
    """One tensor a local shard -> stacked over every shard of the mesh
    (all of them across processes) on the first distinct device."""
    return all_gather(mesh, [{"x": p[None]} for p in parts])[0]["x"]


def _shard_stats(mesh: Mesh, owned, tels) -> dict:
    sh = {"events_owned": _gather_shards(mesh, owned)}
    if tels is not None:
        sh["tel"] = _gather_shards(mesh, tels)
    return sh


def _check_state(mesh: Mesh, state) -> tuple:
    state = tuple(state)
    if len(state) != len(mesh.devices):
        raise ValueError(f"a partitioned state of {len(state)} shards on "
                         f"{len(mesh.devices)} local shards of a mesh of "
                         f"{mesh.size}")
    return state


def make_partitioned_create_transfers(mesh: Mesh, mode: str = "plain",
                                      telemetry: bool = True,
                                      overlay: tuple = ()):
    """The per-batch partitioned step over `mesh` for one kernel tier
    (`mode` in MODES): step(state, ev, timestamp, n) -> (state, out).

    `state` is the tuple of per-shard state dicts (`partitioned_from_
    oracle`), updated in place; `ev` the whole padded batch
    (`pad_transfer_events`, or carrier tensors); timestamp and n Python
    ints. `out` is the single-chip out dict (the first distinct device's)
    plus `flush` (the delta gather of the appended rows),
    `cross_shard_transfers`, `exchange_overflow` and `shard_stats`:
    `events_owned` int32[n_shards] and, with `telemetry`, `tel`
    [n_shards, TEL_WORDS]. `overlay` is the static ownership-override
    tuple."""
    assert mode in MODES, mode

    def step(state, ev, timestamp: int, n: int):
        state = _check_state(mesh, state)
        evs = {d: _ev_on(ev, d) for d in mesh.distinct}
        N = evs[mesh.distinct[0]]["id_lo"].shape[0]
        first = s64(int(timestamp) - int(n) + 1)
        segs = {d: _one_seg(N, first, int(n), d) for d in mesh.distinct}
        reps, owned, tels = _partitioned_batch_body(
            mesh, state, evs, segs, mode=mode, telemetry=telemetry,
            overlay=overlay)
        out = dict(reps[mesh.distinct[0]])
        out["shard_stats"] = _shard_stats(mesh, owned, tels)
        return state, out

    return step


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _chain_run(mesh: Mesh, state, ev_stack: dict, seg_stack: dict,
               force_fallback, *, mode, telemetry, overlay):
    """The chain over per-device stacks ({distinct device: dict of [W, N]
    tensors}): one body a prepare, prepare k's fallback prepare k + 1's
    force_fallback. Reads nothing on the host."""
    d0 = mesh.distinct[0]
    W = ev_stack[d0]["id_lo"].shape[0]
    poisoned = {d: (torch.zeros((), dtype=torch.bool, device=d)
                    if force_fallback is None else force_fallback.to(d))
                for d in mesh.distinct}
    reps_w, owned_w, tels_w = [], [], []
    for k in range(W):
        evs = {d: {key: v[k] for key, v in ev_stack[d].items()}
               for d in mesh.distinct}
        segs = {d: {key: v[k] for key, v in seg_stack[d].items()}
                for d in mesh.distinct}
        reps, owned, tels = _partitioned_batch_body(
            mesh, state, evs, segs, mode=mode, force_fallback=poisoned,
            telemetry=telemetry, overlay=overlay)
        poisoned = {d: reps[d]["fallback"] for d in mesh.distinct}
        reps_w.append(reps[d0])
        owned_w.append(owned)
        tels_w.append(tels)
    out = _stack(reps_w)
    local = range(len(mesh.devices))
    sh = {"events_owned": _gather_shards(mesh, [
        torch.stack([owned_w[k][i] for k in range(W)]) for i in local])}
    if telemetry:
        sh["tel"] = _gather_shards(mesh, [
            torch.stack([tels_w[k][i] for k in range(W)]) for i in local])
    out["shard_stats"] = sh
    return out


def make_partitioned_chain_create_transfers(mesh: Mesh, mode: str = "plain",
                                            telemetry: bool = True,
                                            overlay: tuple = ()):
    """The chain window step: the W prepares of a commit window in one
    call, a rolling poison flag from prepare k into prepare k + 1.

    Returns step(state, ev_stack, ts_stack, n_stack, force_fallback=None)
    -> (state, out): the stacks of `stack_partitioned_window` (every ev
    leaf [W, n_pad], the per-prepare commit timestamps and event counts;
    numpy or carrier tensors). `force_fallback` seeds the poison (None:
    clean). Prepare k's fallback poisons k + 1.. (masked writes: their
    shards stay as they were), so the clean prefix commits and
    out["fallback"] ([W]) tells the caller which suffix to re-window.
    Every out leaf gains a leading W axis; `shard_stats.events_owned` is
    [n_shards, W] and `shard_stats.tel` [n_shards, W, TEL_WORDS].

    `step.lanes(state, lanes, force_fallback)` runs the same chain on
    the ledger's packed window (`ops/ledger.fill_window`'s int64 lane
    matrix on the device): the form a captured CUDA graph replays, as it
    depends on no Python number, and returns out alone."""
    assert mode in MODES, mode
    kw = dict(mode=mode, telemetry=telemetry, overlay=overlay)

    def step(state, ev_stack, ts_stack, n_stack, force_fallback=None):
        state = _check_state(mesh, state)
        evs, segs = {}, {}
        for d in mesh.distinct:
            evs[d] = _ev_on(ev_stack, d)
            ts = (ts_stack.to(d) if isinstance(ts_stack, torch.Tensor)
                  else carrier(np.asarray(ts_stack, dtype=np.uint64), d))
            n = (n_stack.to(d) if isinstance(n_stack, torch.Tensor)
                 else carrier(np.asarray(n_stack), d)).to(torch.int64)
            N = evs[d]["id_lo"].shape[1]
            segs[d] = _one_seg(N, (ts - n + 1)[:, None], n[:, None], d)
            segs[d]["seg_start"] = segs[d]["seg_start"].expand(
                ts.shape[0], N)
        return state, _chain_run(mesh, state, evs, segs, force_fallback,
                                 **kw)

    def lanes(state, lanes_t, force_fallback=None):
        state = _check_state(mesh, state)
        ev, seg = unpack_window(lanes_t)
        evs = {d: {k: v.to(d) for k, v in ev.items()} for d in mesh.distinct}
        segs = {d: {k: v.to(d) for k, v in seg.items()}
                for d in mesh.distinct}
        return _chain_run(mesh, state, evs, segs, force_fallback, **kw)

    step.lanes = lanes
    return step


def stack_partitioned_window(evs: list, timestamps: list,
                             n_pad: int = N_PAD):
    """W unpadded prepares -> the chain step's stacked inputs: each
    prepare padded to n_pad and stacked on a leading W axis, plus the
    per-prepare commit timestamps (uint64) and event counts (int32), in
    the JAX package's dtypes."""
    assert len(evs) == len(timestamps) and evs
    padded = [pad_transfer_events(e, n_pad) for e in evs]
    ev_stack = {k: np.stack([p[k] for p in padded]) for k in padded[0]}
    ts_stack = np.asarray([int(t) for t in timestamps], dtype=np.uint64)
    n_stack = np.asarray([len(e["id_lo"]) for e in evs], dtype=np.int32)
    return ev_stack, ts_stack, n_stack


# --------------------------------------------------------------- host side

def _chunk_insert(table: dict, keys_vals: list, n_pad: int) -> dict:
    """`from_host`'s batch insert: chunked ht_insert of (id, val) pairs,
    with a hard overflow check."""
    dev = table["packed"].device
    for lo_i in range(0, len(keys_vals), n_pad):
        chunk = keys_vals[lo_i:lo_i + n_pad]
        hi = np.array([k >> 64 for k, _ in chunk], dtype=np.uint64)
        lo = np.array([k & ((1 << 64) - 1) for k, _ in chunk],
                      dtype=np.uint64)
        vals = torch.tensor([v for _, v in chunk], dtype=torch.int32,
                            device=dev)
        table, ok = ht_insert(table, carrier(hi, dev), carrier(lo, dev),
                              vals, torch.ones(len(chunk), dtype=torch.bool,
                                               device=dev))
        if not bool(ok):
            raise RuntimeError("hash rebuild overflow: raise capacities")
    return table


def _record_owner_id(sm, rec) -> int:
    """The id that decides a ring row's shard: the creating transfer's
    (keyed by commit timestamp), else the pending transfer's, else the
    debit account's (expiry rows without a commit entry)."""
    tid = sm.transfer_by_timestamp.get(rec.timestamp)
    if tid is not None:
        return tid
    if rec.transfer_pending is not None:
        return rec.transfer_pending.id
    return rec.dr_account.id


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# The orphaned ids the replicated default's transfer table makes room for
# (ops/ledger.py init_state).
ORPHAN_FLOOR = 1 << 16


def shard_caps(a_cap: int, t_cap: int, e_cap, n_shards: int,
               orphan_floor: int = ORPHAN_FLOOR) -> tuple:
    """The per-shard (a_cap, t_cap, orphan_cap, e_cap) of a partitioned
    state at global caps: the global caps / n_shards. The replicated
    default keeps an orphan floor; per shard the floor scales too, so
    the aggregate table is the same size."""
    if a_cap % n_shards or t_cap % n_shards:
        raise ValueError(f"caps {a_cap} / {t_cap} do not divide over "
                         f"{n_shards} shards")
    if e_cap is None:
        e_cap = t_cap
    t_cap_s = t_cap // n_shards
    return (a_cap // n_shards, t_cap_s, max(orphan_floor // n_shards, t_cap_s),
            max(e_cap // n_shards, 1))


def static_partitioned_bytes(a_cap: int, t_cap: int, n_shards: int,
                             e_cap: int | None = None) -> int:
    """The bytes of a partitioned state at global caps over all its
    shards (`partitioned_from_oracle`'s shapes, on the meta device)."""
    from ..ops.ledger import init_state

    a_s, t_s, o_s, e_s = shard_caps(a_cap, t_cap, e_cap, n_shards)
    return n_shards * _tree_bytes(init_state(a_s, t_s, orphan_cap=o_s,
                                             e_cap=e_s, device="meta"))


def partitioned_from_oracle(sm, mesh: Mesh, a_cap: int = 1 << 12,
                            t_cap: int = 1 << 14, e_cap: int | None = None,
                            overlay: tuple = (),
                            orphan_floor: int = ORPHAN_FLOOR) -> tuple:
    """The partitioned state of a host oracle (the port's or the JAX
    package's: any object with its fields): objects go to shards by the
    ownership hash the kernels use (`shard_utils.owner_read_int`), then
    pack per shard in the canonical order (accounts by applied
    timestamp, transfers in commit order, the order the epoch digest
    pins). Per-shard caps are the global caps / n_shards (`shard_caps`,
    with `orphan_floor`). With `overlay`,
    placement follows the read owner. Returns one state dict a local
    shard (`mesh.local`; every shard in one process), on its device;
    packing runs on the CPU."""
    from ..ops.ledger import (_pack_account_rows, _pack_event_rows,
                              _pack_transfer_rows, init_state)
    from ..types import TransferPendingStatus

    n_shards = mesh.size
    a_cap_s, t_cap_s, orphan_cap_s, e_cap_s = shard_caps(
        a_cap, t_cap, e_cap, n_shards, orphan_floor)

    acct_all = sorted(sm.accounts.values(), key=lambda a: a.timestamp)
    xfer_all = [sm.transfers[tid]
                for tid in sm.transfer_by_timestamp.values()]
    orphan_all = sorted(sm.orphaned)

    def shard_of(id128):
        return owner_read_int(id128, n_shards, overlay)

    subs = []
    for i, s in enumerate(mesh.local):
        accounts = [a for a in acct_all if shard_of(a.id) == s]
        transfers = [t for t in xfer_all if shard_of(t.id) == s]
        orphans = [o for o in orphan_all if shard_of(o) == s]
        records = [r for r in sm.account_events
                   if shard_of(_record_owner_id(sm, r)) == s]
        if (len(accounts) > a_cap_s or len(transfers) > t_cap_s
                or len(records) > e_cap_s):
            raise RuntimeError("shard capacity exceeded")
        st = init_state(a_cap_s, t_cap_s, orphan_cap=orphan_cap_s,
                        e_cap=e_cap_s, device="cpu")
        acct_row = {a.id: r for r, a in enumerate(accounts)}
        xfer_row = {t.id: r for r, t in enumerate(transfers)}
        if accounts:
            a_u64, a_bal = _pack_account_rows(accounts)
            st["accounts"]["u64"][:len(accounts)] = torch.from_numpy(
                a_u64.view(np.int64))
            st["accounts"]["bal"][:len(accounts)] = torch.from_numpy(
                a_bal.view(np.int64))
        st["accounts"]["count"].fill_(len(accounts))
        st["acct_ht"] = _chunk_insert(
            st["acct_ht"], [(a.id, r) for r, a in enumerate(accounts)],
            N_PAD)
        if transfers:
            u64m = _pack_transfer_rows(
                transfers,
                lambda o: int(sm.pending_status.get(
                    o.timestamp, TransferPendingStatus.none)),
                lambda aid, dump: acct_row.get(aid, dump),
                a_cap_s)
            st["transfers"]["u64"][:len(transfers)] = torch.from_numpy(
                u64m.view(np.int64))
        st["transfers"]["count"].fill_(len(transfers))
        st["xfer_ht"] = _chunk_insert(
            st["xfer_ht"],
            [(t.id, r) for r, t in enumerate(transfers)]
            + [(o, ORPHAN_VAL) for o in orphans], N_PAD)
        if records:
            ecols = _pack_event_rows(records, acct_row, xfer_row, a_cap_s)
            st["events"]["u64"][:len(records)] = torch.from_numpy(
                ecols["u64"].view(np.int64))
        st["events"]["count"].fill_(len(records))
        # Scalars hold global values on every shard.
        st["acct_key_max"].fill_(s64(sm.accounts_key_max or 0))
        st["xfer_key_max"].fill_(s64(sm.transfers_key_max or 0))
        st["pulse_next"].fill_(s64(sm.pulse_next_timestamp))
        st["commit_ts"].fill_(s64(sm.commit_timestamp))
        subs.append(_to_device(st, mesh.devices[i]))
    return tuple(subs)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def partitioned_state_bytes(state) -> int:
    """Resident state bytes a shard of a partitioned state (the tuple of
    per-shard dicts): the total over the shards / n_shards."""
    state = tuple(state)
    return _tree_bytes(state) // len(state)


def replicated_state_bytes(a_cap: int, t_cap: int,
                           e_cap: int | None = None) -> int:
    """Resident bytes a device of the replicated route at the same caps
    (every device holds the whole state): the comparison base for the
    ~1/n_shards claim. Shapes only (the meta device)."""
    from ..ops.ledger import init_state

    return _tree_bytes(init_state(a_cap, t_cap, e_cap=e_cap,
                                  device="meta"))


class PartitionedRouter:
    """Host-side tier router over the partitioned steps, the sharded-state
    sibling of ShardedRouter: the same flag pre-route, plain -> fixpoint
    escalation and per-cause fallback counters, plus the exchange's
    diagnostics (events routed a shard, cross-shard transfers, exchange
    overflows) decoded from the device telemetry block.

    Windows (`step_window`) take the partitioned chain by default: one
    chain call a window whose every prepare pre-routes plain, with
    per-prepare fallback (the clean prefix stays committed, the first
    ineligible prepare replays through the per-batch step, which
    escalates on the device, and the rest re-windows). Route counters
    ride stats()["routes"] in DeviceLedger.fallback_stats()'s shape.

    Shard loss: no other device holds a lost range, so no single-chip
    reroute can serve. Loss quarantines the router until `resync(oracle)`
    rebuilds the state from the last verified oracle (the `shard_resync`
    recovery cause); both dump the flight recorder."""

    def __init__(self, mesh: Mesh, tracer=None, a_cap: int = 1 << 12,
                 t_cap: int = 1 << 14, e_cap: int | None = None,
                 telemetry: bool = True, flight_recorder=None):
        self.mesh = mesh
        self.tracer = tracer if tracer is not None else NullTracer()
        self.a_cap = a_cap
        self.t_cap = t_cap
        self.e_cap = e_cap
        self.n_shards = mesh.size
        # Elastic shards: the generation-tagged ownership authority. Steps
        # are cached by (mode, overlay entries).
        self.ownership = OwnershipTable(self.n_shards)
        self._staging_host = None  # DeviceLedger.attach_partitioned
        self._steps: dict = {}
        self._chain_steps: dict = {}
        self.batches = 0
        self.escalations = 0
        self.host_fallbacks = 0
        self.fallback_causes: dict = {}
        self.lost_devices: set = set()
        self.shard_resyncs = 0
        self.cross_shard_transfers = 0
        self.exchange_overflows = 0
        self.events_owned = np.zeros(self.n_shards, dtype=np.int64)
        self.window_routes: dict = {}
        self.chain_batch_fallbacks: dict = {}
        # The device telemetry plane: `telemetry` picks the steps built;
        # the aggregates below accumulate the decoded blocks.
        self.telemetry = bool(telemetry)
        self.flight = (flight_recorder if flight_recorder is not None
                       else FlightRecorder(pid=0, tracer=self.tracer))
        self._tel_hist = Histogram()    # exchange occupancy, percent
        self._tel_rounds = Histogram()  # fixpoint rounds a prepare
        self.device_poison_causes: dict = {}
        self.writeback_rows = 0
        self.shard_capacity_hits = 0
        self._window_seq = 0

    # The replicated router's flag-derived tier precedence.
    route = staticmethod(ShardedRouter.route)

    def from_oracle(self, sm) -> tuple:
        """The router's partitioned state of a host oracle (under the
        current ownership table: migrated ranges land on their read
        owner)."""
        return partitioned_from_oracle(sm, self.mesh, self.a_cap,
                                       self.t_cap, self.e_cap,
                                       overlay=self.ownership.entries)

    def set_ownership(self, table: OwnershipTable) -> None:
        """Swap in a new ownership table: the next dispatch picks (or
        builds) the step keyed by the new overlay entries."""
        assert table.n_shards == self.n_shards, table
        assert table.generation >= self.ownership.generation, table
        self.ownership = table

    def _step(self, mode: str):
        key = (mode, self.ownership.entries)
        fn = self._steps.get(key)
        if fn is None:
            fn = self._steps[key] = make_partitioned_create_transfers(
                self.mesh, mode=mode, telemetry=self.telemetry,
                overlay=self.ownership.entries)
        return fn

    def _chain_step(self, mode: str):
        key = (mode, self.ownership.entries)
        fn = self._chain_steps.get(key)
        if fn is None:
            fn = self._chain_steps[key] = \
                make_partitioned_chain_create_transfers(
                    self.mesh, mode=mode, telemetry=self.telemetry,
                    overlay=self.ownership.entries)
        return fn

    def drop_device(self, device, oracle=None):
        """Mark one mesh device lost. Its range exists nowhere else, so
        the router refuses to serve until resynced; with `oracle` the
        resync runs now and its state is returned. Quarantine dumps the
        flight recorder: the ring's tail is the windows before the loss."""
        self.lost_devices.add(device)
        self.flight.record(window=self._window_seq, route="quarantined",
                           lost_devices=len(self.lost_devices))
        self.flight.dump("shard_loss_quarantine")
        if oracle is not None:
            return self.resync(oracle)
        return None

    def resync(self, oracle) -> tuple:
        """Rebuild the partitioned state from the last verified oracle
        (the `shard_resync` recovery cause). The attached ledger's
        staging goes first: a pack staged before the quarantine must not
        be consumed against the rebuilt state."""
        host = self._staging_host
        if host is not None:
            host.shutdown_staging()
        self.flight.dump("shard_resync")
        with self.tracer.span(Event.serving_recovery_replay,
                              cause="shard_resync"):
            state = self.from_oracle(oracle)
        self.tracer.count(Event.serving_recoveries, cause="shard_resync")
        self.shard_resyncs += 1
        self.lost_devices.clear()
        return state

    def restore_devices(self) -> None:
        """The mesh healed without state loss: nothing to rebuild."""
        self.lost_devices.clear()

    def _require_serving(self) -> None:
        if self.lost_devices:
            raise RuntimeError(
                "partitioned shard lost: resync(oracle) required — the "
                "single-chip reroute cannot serve a lost range")

    def _absorb_telemetry(self, tel):
        """Decode one harvested telemetry block ([n_shards, W, TEL_WORDS]
        or [n_shards, TEL_WORDS]) into tracer emissions and the router's
        aggregates; returns the window's summary for the flight recorder
        (None when empty). Replicated words are equal on every shard (max
        over the shard axis reads them); per-shard words stay per shard."""
        tel = _np(tel)
        if tel.ndim == 2:
            tel = tel[:, None, :]
        if tel.shape[1] == 0:
            return None
        d = decode_telemetry(tel)
        rep = {k: d[k].max(axis=0) for k in (
            "fix_rounds", "poison_cause",
            "xchg1_occupancy", "xchg1_capacity",
            "xchg2_occupancy", "xchg2_capacity",
            "cross_shard_transfers", "exchange_overflow")}
        W = tel.shape[1]
        occ_pct = []
        causes = []
        for w in range(W):
            self.tracer.observe(Event.device_fixpoint_rounds,
                                int(rep["fix_rounds"][w]))
            self._tel_rounds.record(float(rep["fix_rounds"][w]))
            for phase, occ, cap in (
                    ("transfers", rep["xchg1_occupancy"][w],
                     rep["xchg1_capacity"][w]),
                    ("accounts", rep["xchg2_occupancy"][w],
                     rep["xchg2_capacity"][w])):
                pct = (100.0 * float(occ) / float(cap)) if cap else 0.0
                pct = round(pct, 3)
                occ_pct.append(pct)
                self.tracer.observe(Event.device_exchange_occupancy, pct,
                                    phase=phase)
                self._tel_hist.record(pct)
            code = int(rep["poison_cause"][w])
            cause = (TEL_CAUSES[code - 1] if 0 < code <= len(TEL_CAUSES)
                     else (f"code_{code}" if code else None))
            causes.append(cause)
            if cause is not None:
                self.device_poison_causes[cause] = (
                    self.device_poison_causes.get(cause, 0) + 1)
                self.tracer.count(Event.device_poison_cause, cause=cause)
        for s in range(tel.shape[0]):
            for w in range(W):
                self.tracer.observe(Event.device_ring_occupancy,
                                    int(d["ring_occupancy"][s, w]))
        wb = int(d["writeback_transfers"].sum())
        if wb:
            self.writeback_rows += wb
            self.tracer.count(Event.device_writeback_rows, value=wb)
        self.shard_capacity_hits += int(d["shard_capacity_hit"].sum())
        return {
            "prepares": W,
            "fix_rounds": [int(x) for x in rep["fix_rounds"]],
            "poison_causes": causes,
            "exchange_occupancy_pct": occ_pct,
            "cross_shard_transfers": int(rep["cross_shard_transfers"].sum()),
            "exchange_overflows": int(rep["exchange_overflow"].sum()),
            "shard_capacity_hits": int(d["shard_capacity_hit"].sum()),
            "writeback_rows": wb,
            "events_owned": [int(x) for x in d["events_owned"].sum(axis=1)],
            "ring_occupancy": [int(x) for x in d["ring_occupancy"][:, -1]],
        }

    def step(self, state, ev: dict, timestamp: int, n: int):
        """Run one padded batch (`pad_transfer_events`). Returns (state,
        out, fell_back); on fell_back the state is as it was and the
        caller owns the exact-path replay."""
        self._require_serving()
        self.batches += 1
        mode = self.route(ev)
        self.tracer.count(Event.dispatch_route, route="partitioned_" + mode)
        with self.tracer.span(Event.shard_exchange, mode=mode):
            state, out = self._step(mode)(state, ev, timestamp, n)
            fallback, limit_only = (bool(x) for x in torch.stack(
                (out["fallback"], out["limit_only"])).tolist())
            if fallback and limit_only and mode == "plain":
                self.escalations += 1
                mode = "fixpoint"
                state, out = self._step("fixpoint")(state, ev, timestamp, n)
                fallback = bool(out["fallback"])
        if self.telemetry:
            # The harvested block is the probe: the shard diagnostics
            # decode from the words the tracer and the flight recorder see.
            tel = _np(out["shard_stats"]["tel"])
            d = decode_telemetry(tel)
            xs = int(d["cross_shard_transfers"].max())
            ov = int(d["exchange_overflow"].max())
            owned = d["events_owned"]
            summary = self._absorb_telemetry(tel)
            self.flight.record(window=self._window_seq,
                               route="partitioned_" + mode,
                               telemetry=summary)
        else:
            xs = int(out["cross_shard_transfers"])
            ov = int(out["exchange_overflow"])
            owned = _np(out["shard_stats"]["events_owned"])
        if xs:
            self.cross_shard_transfers += xs
            self.tracer.count(Event.cross_shard_transfers, value=xs)
        self.exchange_overflows += int(bool(ov))
        self.events_owned += np.asarray(owned, dtype=np.int64)
        if fallback:
            self.host_fallbacks += 1
            for k, v in out["fb_causes"].items():
                if bool(v):
                    self.fallback_causes[k] = (
                        self.fallback_causes.get(k, 0) + 1)
                    self.tracer.count(Event.router_fallback, cause=k)
        return state, out, fallback

    # ---- the chain window (the default partitioned route) ----

    def _count_window(self, route: str) -> None:
        self.window_routes[route] = self.window_routes.get(route, 0) + 1
        self._window_seq += 1

    def stage_operands(self, evs: list, timestamps: list, n_pad: int):
        """One chain window's packed operands: the ledger's int64 lane
        matrix (`fill_window`, (lanes, W, n_pad)) on the host. Pure host
        work: no router state is read."""
        lanes = np.empty((len(_LANES), len(evs), n_pad), dtype=np.int64)
        fill_window(lanes, evs, timestamps, n_pad)
        return torch.from_numpy(lanes)

    def chain_dispatch(self, state, evs: list, timestamps: list,
                       n_pad: int | None = None, force_fallback=None,
                       staged=None, graphs=None):
        """One chain call over a whole window, unresolved: every out leaf
        stays on the device with a leading W axis. Pipelined callers
        (DeviceLedger.submit_window) thread out["fallback"][-1] into the
        next window's force_fallback. `staged`: the window's lane matrix
        (`stage_operands`, on the host or already on the device).
        `graphs`: the ledger's WindowGraphs, which runs the call as a
        captured CUDA graph on the card under the key
        ("partitioned_chain", W, n_pad, overlay entries); None runs it
        eagerly. The body the graph captured depends on the ownership
        overlay, so a new overlay is a new key. A multi-process mesh is
        refused there: its gloo collectives cannot be captured. Counts
        the window under the partitioned_chain route."""
        self._require_serving()
        if n_pad is None:
            n_pad = _pad_bucket(max(len(e["id_lo"]) for e in evs))
        lanes = (staged if staged is not None
                 else self.stage_operands(evs, timestamps, n_pad))
        self._count_window("partitioned_chain")
        self.tracer.count(Event.dispatch_route, route="partitioned_chain")
        call = self._chain_step("plain").lanes
        with self.tracer.span(Event.shard_exchange, mode="chain"):
            if graphs is not None:
                graphs.check_mesh(self.mesh)
                key = ("partitioned_chain", lanes.shape[1], n_pad,
                       self.ownership.entries)
                return graphs.run(key, call, state, lanes, force_fallback)
            lanes = lanes.to(self.mesh.distinct[0])
            return call(state, lanes, force_fallback)

    def absorb_chain_prefix(self, out, k: int, n_prepares: int) -> None:
        """Accumulate one chain window's committed-prefix counters
        (prepares [0, k)) and, when k < n_prepares, the fallback causes
        at prepare k (later prepares carry only the poison). `out` is the
        window's outputs, on the device or harvested to numpy. The
        replayed suffix counts itself through the per-batch step."""
        self.batches += k
        tel = None
        if self.telemetry and "tel" in out.get("shard_stats", {}):
            tel = _np(out["shard_stats"]["tel"])
        if k:
            if tel is not None:
                d = decode_telemetry(tel[:, :k])
                xs = int(d["cross_shard_transfers"].max(axis=0).sum())
                owned = d["events_owned"].sum(axis=1)
                self.exchange_overflows += int(
                    d["exchange_overflow"].max(axis=0).sum())
            else:
                xs = int(_np(out["cross_shard_transfers"])[:k].sum())
                owned = _np(out["shard_stats"]["events_owned"])[:, :k].sum(
                    axis=1)
            if xs:
                self.cross_shard_transfers += xs
                self.tracer.count(Event.cross_shard_transfers, value=xs)
            self.events_owned += np.asarray(owned, dtype=np.int64)
        if tel is not None:
            # The committed prefix's telemetry, and prepare k's when the
            # window poisoned there (its cause is the headline).
            upto = min(k + 1, n_prepares) if k < n_prepares else k
            summary = self._absorb_telemetry(tel[:, :upto])
            self.flight.record(window=self._window_seq,
                               route="partitioned_chain", telemetry=summary,
                               prepares=n_prepares, committed_prefix=k)
        if k < n_prepares:
            for cause, v in out["fb_causes"].items():
                if bool(_np(v)[k]):
                    self.chain_batch_fallbacks[cause] = (
                        self.chain_batch_fallbacks.get(cause, 0) + 1)

    def _window_per_batch(self, state, evs, timestamps, n_pad,
                          count_route=True):
        """The per-batch window ladder: one step a prepare (plain ->
        fixpoint escalation on the device). The replay path of a chain
        window's fallen-back prepare, and the pre-route of windows with
        flags the plain chain cannot serve."""
        if count_route:
            self._count_window("partitioned_per_batch")
        results = []
        for ev, ts in zip(evs, timestamps):
            n_b = len(ev["id_lo"])
            pe = pad_transfer_events(ev, n_pad)
            state, out, _fb = self.step(state, pe, ts, n_b)
            results.append((_np(out["r_status"])[:n_b].astype(np.uint32),
                            _np(out["r_ts"])[:n_b].view(np.uint64).copy()))
        return state, results

    def step_window(self, state, evs: list, timestamps: list,
                    n_pad: int | None = None):
        """Commit one window of W prepares (unpadded transfers_to_arrays
        dicts). Returns (state, results), one (status uint32[n_b], ts
        uint64[n_b]) pair a prepare.

        The default route is the partitioned chain: one chain call for
        the whole window when every prepare pre-routes plain (imported,
        balancing and closing windows take the per-batch ladder). On a
        fallback at prepare k the clean prefix [0, k) stands, prepare k
        replays per batch (escalating on the device) and the rest
        re-windows."""
        W = len(evs)
        if W == 0:
            return state, []
        self._require_serving()
        ns = [len(e["id_lo"]) for e in evs]
        if n_pad is None:
            n_pad = _pad_bucket(max(ns))
        if W < 2 or any(self.route(e) != "plain" for e in evs):
            return self._window_per_batch(state, evs, timestamps, n_pad)
        out = self.chain_dispatch(state, evs, timestamps, n_pad)
        fb = _np(out["fallback"])
        k = int(np.argmax(fb)) if fb.any() else W
        self.absorb_chain_prefix(out, k, W)
        st_all, ts_all = _np(out["r_status"]), _np(out["r_ts"])
        results = [(st_all[b, :ns[b]].astype(np.uint32),
                    ts_all[b, :ns[b]].view(np.uint64).copy())
                   for b in range(k)]
        if k == W:
            return state, results
        # Prepare k replays per batch (the device ladder serves limit
        # cascades without a host fallback); the poisoned suffix, whose
        # shards are as the prefix left them, re-windows.
        state, res_k = self._window_per_batch(
            state, evs[k:k + 1], timestamps[k:k + 1], n_pad,
            count_route=False)
        results.extend(res_k)
        if k + 1 < W:
            state, rest = self.step_window(state, evs[k + 1:],
                                           timestamps[k + 1:], n_pad)
            results.extend(rest)
        return state, results

    def stats(self) -> dict:
        total = int(self.events_owned.sum())
        return {
            "batches": self.batches,
            "escalations": self.escalations,
            "host_fallbacks": self.host_fallbacks,
            "causes": dict(self.fallback_causes),
            "lost_devices": len(self.lost_devices),
            "shard_resyncs": self.shard_resyncs,
            "cross_shard_transfers": self.cross_shard_transfers,
            "exchange_overflows": self.exchange_overflows,
            "events_owned": [int(x) for x in self.events_owned],
            "cross_shard_fraction": (
                self.cross_shard_transfers / total if total else 0.0),
            # DeviceLedger.fallback_stats()["routes"]'s shape: windows a
            # route and the per-cause prepares that fell out of a chain.
            "routes": {
                "windows": dict(self.window_routes),
                "chain_batch_fallbacks": dict(self.chain_batch_fallbacks),
            },
            # Decoded from the telemetry block harvested with the outputs.
            "telemetry": None if not self.telemetry else {
                "device_poison_causes": dict(self.device_poison_causes),
                "writeback_rows": int(self.writeback_rows),
                "shard_capacity_hits": int(self.shard_capacity_hits),
                "exchange_occupancy": self._tel_hist.to_dict(),
                "fixpoint_rounds": self._tel_rounds.summary(),
                "flight_windows": self.flight.seq,
                "flight_dumps": self.flight.dumps,
            },
        }
