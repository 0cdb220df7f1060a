"""Vectorized create_transfers / create_accounts over the device ledger.

A port of the JAX package's `ops/fast_kernels.py`: every per-event check
is evaluated on the whole batch at once, chains are resolved with a
segment first-failure broadcast, and balances are applied through
carry-safe u32-limb prefix sums.

Exactness: a batch runs here iff its statuses are provably
order-independent, or (the fixpoint tiers) its order-dependent decisions
converge within the tier's round budget. The kernel checks eligibility
on the device and returns a `fallback` flag; when it is set, every write
is masked to the dump rows (or rewrites a row with its own value), so
the state is left as it was.

Tiers (`limit_rounds`):
  1      the plain tier: E1 hard flags, E2 in-batch id/pending
         collisions, E3 balance-limit headroom, E4 u128 overflow, E5
         voids of closing pendings, E7/E8 capacity. A fallback whose only
         causes the fixpoint tiers resolve is marked `limit_only`.
  K > 1  the limit fixpoint tiers (K = 8 and 32): same-kind duplicates
         stay a fallback, in-batch pending references are joined
         (`_dup_and_pend_join`) and read from the definition's event
         lanes (`_inwin_def_view`), and the order-dependent decisions —
         balance limits, in-batch pending deaths, the closed-account
         state (closing is native on every fixpoint tier) — run a
         K-round status fixpoint over exact per-event prefix balances.
         A cascade deeper than K reports `fix_unconverged`.
The superbatch/window, imported and balancing tiers are later slices of
the port.

Every row gather goes through `row_gather` / `row_gather_multi` (the
CUDA row-gather kernel on the card, `csrc/row_gather.cu`; tables read
at one stage share a launch); 1-D element gathers stay torch indexing.
Both hash probes of a tier run share one launch of the probe kernel
(`ht_lookup_fused_multi`, `csrc/ht_probe.cu`).

u64 lanes ride as int64 (see `u64.py`); the per-event 32-bit fields as
int64 holding the u32 value; statuses as int64 holding the u32 wire
code; row indexes as int64. The state is updated in place (the port's
analog of the JAX package's donated buffers) and returned.
"""

from __future__ import annotations

import torch

from ..constants import NS_PER_S, U63_MAX
from . import u128
from .create_kernels import (
    _A_CLOSED,
    _A_CR_LIMIT,
    _A_DR_LIMIT,
    _A_IMPORTED,
    _A_LINKED,
    _AF_PADDING,
    _AS,
    _CREATED,
    _F_BAL_CR,
    _F_BAL_DR,
    _F_CLOSE_CR,
    _F_CLOSE_DR,
    _F_IMPORTED,
    _F_LINKED,
    _F_PENDING,
    _F_POST,
    _F_VOID,
    _PS_EXPIRED,
    _PS_PENDING,
    _PS_POSTED,
    _PS_VOIDED,
    _TF_PADDING,
    _TRANSIENT_CODES,
    _TS,
    _ct_eval_exists,
    _first_failure,
    _flag,
)
from .ev_layout import (
    AC_P32,
    AC_P32_POS,
    AC_U64,
    AC_U64_IDX,
    BAL_IDX,
    EV_P32,
    EV_U64,
    XF_P32,
    XF_P32_POS,
    XF_U64,
    ev_cap,
    pack32,
    xf_named,
)
from .fused_probe import ht_lookup_fused, ht_lookup_fused_multi
from .hash_table import ORPHAN_VAL, ht_plan, ht_write
from .row_gather import row_gather, row_gather_multi
from .u64 import (
    M32,
    U64_MAX,
    s64,
    srl,
    ucummin,
    ugt,
    ule,
    umax,
    umax_reduce,
    umin,
    umin_reduce,
)

_INF = 0x7FFFFFFF

# The order-dependent-limits tiers: a K-round status fixpoint resolves
# headroom-proof breaches natively; a cascade deeper than K waves
# escalates to the deep tier, then falls back.
LIMIT_FIXPOINT_ROUNDS = 8
LIMIT_FIXPOINT_ROUNDS_DEEP = 32


# --------------------------------------------------- cumulative reductions

def _cumsum(x, dim=-1):
    return torch.cumsum(x, dim=dim)


def _cummin(x, dim=-1):
    return torch.cummin(x, dim=dim).values


def _cummax(x, dim=-1):
    return torch.cummax(x, dim=dim).values


# ------------------------------------------------------------ limb helpers

def _to_limbs(hi, lo):
    """(hi, lo) u64 pair -> 4 x u32-normalized limbs in u64 lanes."""
    return (lo & M32, srl(lo, 32), hi & M32, srl(hi, 32))


def _from_limbs(l0, l1, l2, l3):
    """Normalized limbs -> (hi, lo)."""
    return (l2 | (l3 << 32), l0 | (l1 << 32))


def _neg_limbs(hi, lo):
    """Limbs of (2^128 - x) mod 2^128: two's complement for the
    scatter-subtract of pending releases."""
    n_lo = (~lo) + 1
    n_hi = (~hi) + (lo == 0).to(torch.int64)
    return _to_limbs(n_hi, n_lo)


def _u128_max_reduce(his, los):
    """Exact unsigned max over a list of (hi, lo) tensors of one shape;
    returns 0-dim (hi, lo)."""
    hi = his[0]
    lo = los[0]
    for h, l in zip(his[1:], los[1:]):
        take = ugt(h, hi) | ((h == hi) & ugt(l, lo))
        hi = torch.where(take, h, hi)
        lo = torch.where(take, l, lo)
    mhi = umax_reduce(hi)
    mlo = umax_reduce(torch.where(hi == mhi, lo, 0))
    return mhi, mlo


def _lexsort_perm(keys):
    """Stable sort permutation by several keys, most significant first:
    successive stable sorts, least significant key first."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else k[perm]
        p = torch.argsort(kk, stable=True)
        perm = p if perm is None else perm[p]
    return perm


def _dup_keys(k_hi, k_lo, tags):
    """True if any two tagged keys are equal. Sorted by (key,
    tagged-first), tagged duplicates are adjacent even when untagged
    copies of the same key sit between them. The order over int64-carried
    keys differs from the JAX package's u64 order; only the adjacency of
    equal keys is read, and that is the same."""
    untag = (~tags).to(torch.int64)
    perm = _lexsort_perm([k_hi, k_lo, untag])
    s_hi, s_lo, s_tag = k_hi[perm], k_lo[perm], tags[perm]
    eq = (s_hi[1:] == s_hi[:-1]) & (s_lo[1:] == s_lo[:-1])
    both = s_tag[1:] & s_tag[:-1]
    return torch.any(eq & both)


def _combined_dup_keys(ev, valid, pv):
    """Plain tier: any two tagged keys (ids and pending ids in one pool)
    equal — a duplicate id or an in-batch pending reference; the
    fixpoint tiers tell them apart with `_dup_and_pend_join`."""
    tag = valid & ~((ev["id_hi"] == 0) & (ev["id_lo"] == 0))
    ptag = valid & pv & ~((ev["pid_hi"] == 0) & (ev["pid_lo"] == 0))
    return _dup_keys(
        torch.cat([ev["id_hi"], ev["pid_hi"]]),
        torch.cat([ev["id_lo"], ev["pid_lo"]]),
        torch.cat([tag, ptag]))


def _dup_and_pend_join(ev, valid, pv, idxs, N):
    """Duplicate-key eligibility + in-batch pending join (fixpoint tiers).

    Keys: every tagged id (a potential in-batch pending DEFINITION) and
    every tagged pid (a USE). Same-kind duplicates (two ids, or two
    pids) are the fallback condition E2. A pid matching an id is the
    in-batch pending join (reference: post_or_void_pending_transfer
    resolves against the groove, which already holds same-batch
    creations, src/state_machine.zig:4053-4112).

    Returns (dups, inwin, didx): dups = any same-kind duplicate; inwin =
    this use has an in-batch definition EARLIER in the stream; didx = the
    definition's event index (0 where absent; always gate on inwin).

    The JAX package sorts once by (key, tagged-first, defs-before-uses,
    stream order); here that is successive stable sorts, least
    significant key first, the three small keys packed into one int64
    (seq < 2^31). Over int64-carried keys the order of DIFFERENT keys
    differs from u64 order; only runs of equal keys are read, and inside
    a run the order — defs before uses, then stream order, on which
    didx depends — is the same."""
    dev = idxs.device
    tag = valid & ~((ev["id_hi"] == 0) & (ev["id_lo"] == 0))
    ptag = valid & pv & ~((ev["pid_hi"] == 0) & (ev["pid_lo"] == 0))
    k_hi = torch.cat([ev["id_hi"], ev["pid_hi"]])
    k_lo = torch.cat([ev["id_lo"], ev["pid_lo"]])
    tags = torch.cat([tag, ptag])
    kind = torch.cat([torch.zeros(N, dtype=torch.int64, device=dev),
                      torch.ones(N, dtype=torch.int64, device=dev)])
    seq = torch.cat([idxs, idxs])
    untag = (~tags).to(torch.int64)
    order = _lexsort_perm([k_hi, k_lo, (untag << 33) | (kind << 32) | seq])
    s_hi, s_lo = k_hi[order], k_lo[order]
    s_kind, s_seq, s_tag = kind[order], seq[order], tags[order]
    eq = (s_hi[1:] == s_hi[:-1]) & (s_lo[1:] == s_lo[:-1])
    both = s_tag[1:] & s_tag[:-1]
    dups = torch.any(eq & both & (s_kind[1:] == s_kind[:-1]))
    # Runs of equal TAGGED keys; each run holds <= 1 def (else dups),
    # and the sort puts it FIRST in its run. The run's def index
    # forward-fills with one running max over (run_id << 32) | (def + 1):
    # run_id is non-negative and below 2^31, so signed int64 order is the
    # JAX package's unsigned order here.
    run_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           ~(eq & both)])
    run_id = _cumsum(run_start.to(torch.int64)) - 1
    def_val = torch.where(s_tag & (s_kind == 0), s_seq, -1)
    fill = _cummax((run_id << 32) | (def_val + 1))
    didx_sorted = (fill & M32) - 1
    same_run = (fill >> 32) == run_id
    use_here = s_tag & (s_kind == 1)
    hit_sorted = use_here & same_run & (didx_sorted >= 0)
    # Back to event positions: `order` is a permutation, so a plain
    # (non-accumulating) copy is deterministic.
    val_sorted = torch.where(hit_sorted, didx_sorted + 1, 0)
    val_full = torch.zeros(2 * N, dtype=torch.int64,
                           device=dev).index_copy_(0, order, val_sorted)
    inwin = val_full[N:] > 0
    didx = torch.clamp(val_full[N:] - 1, min=0)
    # Sequential truth: only definitions EARLIER in the stream exist at
    # the use's evaluation point.
    inwin = inwin & (didx < idxs)
    return dups, inwin, torch.where(inwin, didx, 0)


_FIELDS = ("dp", "dpos", "cp", "cpos")
_FI = {f: i for i, f in enumerate(_FIELDS)}


def _delta_lanes2(ap_reg, ap_pend, ap_pv, ap_post, al, nl):
    """(4 fields, 4 limbs, 2N) per-entry balance delta lanes — debit-side
    entries then credit-side entries — from the application masks. The
    fixpoint tiers build the same lanes in sorted entry space
    (`_sorted_lanes`); any change to which lane an amount lands in must
    be made at both. All lanes are < 2^32, so segment prefix sums stay
    carry-safe."""
    def ln(cond_pos, limbs, cond_neg=None, nlimbs=None):
        out = []
        for j in range(4):
            lane = torch.where(cond_pos, limbs[j], 0)
            if cond_neg is not None:
                lane = lane + torch.where(cond_neg, nlimbs[j], 0)
            out.append(lane)
        return out

    zero4 = [torch.zeros_like(al[0])] * 4
    dr_side = {
        "dp": ln(ap_pend, al, ap_pv, nl),
        "dpos": ln(ap_reg | ap_post, al),
        "cp": zero4, "cpos": zero4,
    }
    cr_side = {
        "dp": zero4, "dpos": zero4,
        "cp": ln(ap_pend, al, ap_pv, nl),
        "cpos": ln(ap_reg | ap_post, al),
    }
    return torch.stack([
        torch.stack([torch.cat([dr_side[f][j], cr_side[f][j]])
                     for j in range(4)])
        for f in _FIELDS])


def _apply_mask8(ap, pv, pending, is_post, is_void, close_dr_f,
                 close_cr_f, p_cl_dr, p_cl_cr):
    """One packed u8 apply mask per event: bits 0-3 the delta lanes
    (regular, pending, post/void, post), 4/5 an applied closing create
    (dr/cr side), 6/7 an applied void of a closing pending."""
    bits = [ap & ~pv & ~pending, ap & ~pv & pending, ap & pv,
            ap & pv & is_post, ap & ~pv & close_dr_f, ap & ~pv & close_cr_f,
            ap & pv & is_void & p_cl_dr, ap & pv & is_void & p_cl_cr]
    m = torch.zeros_like(ap, dtype=torch.uint8)
    for b, v in enumerate(bits):
        m = m | (v.to(torch.uint8) << b)
    return m


def _sorted_lanes(m_s, cr_side_s, al_s, nl_s):
    """(4 fields, 4 limbs, 2N) delta lanes in sorted entry space from the
    sorted packed apply mask and the hoisted sorted amount limbs — the
    lane semantics of `_delta_lanes2`."""
    reg_s = (m_s & 1) != 0
    pend_s = (m_s & 2) != 0
    pv_s = (m_s & 4) != 0
    post_s = (m_s & 8) != 0
    held = [torch.where(pend_s, al_s[j], 0) + torch.where(pv_s, nl_s[j], 0)
            for j in range(4)]
    posted = [torch.where(reg_s | post_s, al_s[j], 0) for j in range(4)]
    return torch.stack([
        torch.stack([torch.where(cr_side_s, 0, held[j])
                     for j in range(4)]),       # dp
        torch.stack([torch.where(cr_side_s, 0, posted[j])
                     for j in range(4)]),       # dpos
        torch.stack([torch.where(cr_side_s, held[j], 0)
                     for j in range(4)]),       # cp
        torch.stack([torch.where(cr_side_s, posted[j], 0)
                     for j in range(4)]),       # cpos
    ])


def _closed_ops(m_s, cr_side_s):
    """(set, clear) closed-state ops per sorted entry from the packed
    apply mask's bits 4-7."""
    set_s = torch.where(cr_side_s, (m_s & 32) != 0, (m_s & 16) != 0)
    clr_s = torch.where(cr_side_s, (m_s & 128) != 0, (m_s & 64) != 0)
    return set_s, clr_s


def _normalize_limbs(limbs):
    """(4, 4, 2N) un-normalized limb stacks -> mod-2^128 u32-normalized
    (3 carry steps; the final carry-out is discarded = mod 2^128)."""
    l0 = limbs[:, 0]
    l1 = limbs[:, 1]
    l2 = limbs[:, 2]
    l3 = limbs[:, 3]
    c = srl(l0, 32)
    l0 = l0 & M32
    l1 = l1 + c
    c = srl(l1, 32)
    l1 = l1 & M32
    l2 = l2 + c
    c = srl(l2, 32)
    l2 = l2 & M32
    l3 = (l3 + c) & M32
    return l0, l1, l2, l3


def _packed_perm(rows2, order2, row_cap):
    """Stable (row, event-order) sort permutation via ONE int64 sort of a
    packed key: pb bits each for order and the entry-position tiebreak,
    the rest for the row."""
    n2 = rows2.shape[0]
    pb = max(17, (n2 - 1).bit_length())
    assert 2 * pb + (int(row_cap) - 1).bit_length() <= 62
    pos = torch.arange(n2, dtype=torch.int64, device=rows2.device)
    combined = ((rows2 << (2 * pb)) | (order2 << pb)
                | (pos & ((1 << pb) - 1)))
    return torch.argsort(combined, stable=True)


def _chain_pass(status, linked, valid, idxs, n, N):
    """Linked-chain first-failure broadcast (reference execute_create
    :3033-3150): returns (status, not_the_failure, my_first, in_chain)
    where not_the_failure marks members overridden to
    linked_event_failed. Pure in `status`: the fixpoint re-runs it per
    round."""
    dev = status.device
    l_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                        linked[:-1]])
    in_chain = linked | l_prev
    start = linked & ~l_prev
    chain_id = _cumsum(start.to(torch.int64))
    is_last = idxs == (n - 1)
    chain_open_evt = linked & is_last
    status = torch.where(chain_open_evt, _TS["linked_event_chain_open"],
                         status)
    fail = in_chain & valid & (status != _CREATED)
    fail_pos = torch.where(fail, idxs, _INF)
    seg_first = torch.full((N + 1,), _INF, dtype=torch.int64, device=dev)
    seg_first = seg_first.scatter_reduce(0, chain_id, fail_pos, "amin")
    my_first = seg_first[chain_id]
    broken = in_chain & (my_first != _INF)
    # chain_open is applied after chain_broken in the sequential order
    # (reference execute_create :3096-3104): the open-chain terminator
    # keeps linked_event_chain_open even when an earlier member failed.
    not_the_failure = broken & (idxs != my_first) & ~chain_open_evt
    status = torch.where(not_the_failure, _TS["linked_event_failed"],
                         status)
    return status, not_the_failure, my_first, in_chain


def _u128_over(l0, l1, l2, l3, right_hi, right_lo):
    """(limb sum, each limb < 2^46) > right, in 5 limbs."""
    c = srl(l0, 32)
    f0 = l0 & M32
    l1 = l1 + c
    c = srl(l1, 32)
    f1 = l1 & M32
    l2 = l2 + c
    c = srl(l2, 32)
    f2 = l2 & M32
    l3 = l3 + c
    l4 = srl(l3, 32)
    f3 = l3 & M32
    left_hi = f2 | (f3 << 32)
    left_lo = f0 | (f1 << 32)
    return (l4 > 0) | u128.lt(right_hi, right_lo, left_hi, left_lo)


# ================================================== create_transfers (fast)

# Packed 32-bit account meta columns (ev_layout.AC_P32): ledger is the
# high half of (ud32|ledger), code/flags the halves of the next word.
_AC_UL_COL = AC_P32_POS["ud32"][0]
_AC_CF_COL = AC_P32_POS["code"][0]


def _acct_unpack(g_bal, g64, found):
    """Named account fields from gathered rows (balance limbs + the
    packed u64 meta row)."""
    def field(name):
        i = BAL_IDX[name]
        return _from_limbs(g_bal[:, i], g_bal[:, i + 1],
                           g_bal[:, i + 2], g_bal[:, i + 3])

    cf = g64[:, _AC_CF_COL]
    return dict(
        exists=found,
        dp=field("dp"),
        dpos=field("dpos"),
        cp=field("cp"),
        cpos=field("cpos"),
        ledger=srl(g64[:, _AC_UL_COL], 32),
        code=cf & M32,
        flags=srl(cf, 32),
        ts=g64[:, AC_U64_IDX["ts"]],
    )


def _acct_gather_multi(acc, rows_list, found_list):
    """K account-role gathers as ONE two-table row gather (balances and
    meta) over the concatenated row set. Returns one named dict per
    role."""
    rows = torch.cat(rows_list)
    g_bal, g64 = row_gather_multi((acc["bal"], acc["u64"]), rows)
    outs = []
    off = 0
    for r, found in zip(rows_list, found_list):
        n = r.shape[0]
        outs.append(_acct_unpack(g_bal[off:off + n], g64[off:off + n],
                                 found))
        off += n
    return outs


def _xfer_gather_multi(xfr, rows_list):
    """K transfer-role gathers as ONE row gather."""
    rows = torch.cat(rows_list)
    g64 = row_gather(xfr["u64"], rows)
    outs = []
    off = 0
    for r in rows_list:
        n = r.shape[0]
        outs.append(xf_named({"u64": g64[off:off + n]}))
        off += n
    return outs


_IDV_U64 = ("id_hi", "id_lo", "dr_hi", "dr_lo", "cr_hi", "cr_lo",
            "amt_hi", "amt_lo", "pid_hi", "pid_lo", "ud128_hi",
            "ud128_lo", "ud64")
_IDV_32 = ("ud32", "timeout", "ledger", "code", "flags")
# The 32-bit def-side lanes ride pair-packed (ev_layout.pack32) beside
# the wide lanes, so the whole view is ONE row gather.
_IDV_P32 = (("ud32", "timeout"), ("ledger", "code"),
            ("flags", "dr_rowc"), ("cr_rowc",))


def _inwin_def_view(ev, ts_event, didx, dr_rowc, cr_rowc):
    """Pending-transfer view of an in-batch DEFINITION read from its
    event lanes (reference: the groove already holds same-batch
    creations at post_or_void time, src/state_machine.zig:4053-4112).
    dr_rowc/cr_rowc are the per-event account-row probe results the
    definition's rows come from.

    The 18 def-side lanes are stacked (N, 18) row-major and contiguous,
    so the gather at didx is one `row_gather`."""
    src32 = {k: ev[k] for k in _IDV_32}
    src32["dr_rowc"] = dr_rowc
    src32["cr_rowc"] = cr_rowc
    view = torch.stack(
        [ev[k] for k in _IDV_U64] + [ts_event]
        + [pack32(src32[pr[0]], src32[pr[1]] if len(pr) > 1 else None)
           for pr in _IDV_P32], dim=1)
    g = row_gather(view, didx)
    out = {k: g[:, i] for i, k in enumerate(_IDV_U64)}
    base = len(_IDV_U64) + 1
    for j, pr in enumerate(_IDV_P32):
        word = g[:, base + j]
        for half, name in enumerate(pr):
            out[name] = srl(word, 32) if half else word & M32
    d_ts = g[:, len(_IDV_U64)]
    out.update(
        ts=d_ts,
        expires=torch.where(out["timeout"] != 0,
                            d_ts + out["timeout"] * NS_PER_S, 0),
        pstat=torch.where(_flag(out["flags"], _F_PENDING), _PS_PENDING, 0),
        dr_row=out.pop("dr_rowc"),
        cr_row=out.pop("cr_rowc"),
    )
    return out


def _pv_eval(ev, p, p_found, p_dr, p_cr, ts_event):
    """Post/void evaluation (reference :4053-4112): sentinel amount
    resolution + the ordered check list. Returns (pv_status,
    pv_status_nf, pv_amt_hi, pv_amt_lo), where pv_status_nf is the
    dead/missing-definition variant: the same sequence with the lookup
    missing."""
    flags = ev["flags"]
    pending = _flag(flags, _F_PENDING)
    is_post = _flag(flags, _F_POST)
    is_void = _flag(flags, _F_VOID)

    pv_amt_hi, pv_amt_lo = u128.select(
        torch.where(is_void,
                    u128.is_zero(ev["amt_hi"], ev["amt_lo"]),
                    u128.is_max(ev["amt_hi"], ev["amt_lo"])),
        p["amt_hi"], p["amt_lo"], ev["amt_hi"], ev["amt_lo"])

    p_expires_due = (p["timeout"] != 0) & ule(p["expires"], ts_event)
    pid_zero = u128.is_zero(ev["pid_hi"], ev["pid_lo"])
    pid_max = u128.is_max(ev["pid_hi"], ev["pid_lo"])
    pv_checks = [
        (is_post & is_void, _TS["flags_are_mutually_exclusive"]),
        (pending | _flag(flags, _F_BAL_DR) | _flag(flags, _F_BAL_CR)
         | _flag(flags, _F_CLOSE_DR) | _flag(flags, _F_CLOSE_CR),
         _TS["flags_are_mutually_exclusive"]),
        (pid_zero, _TS["pending_id_must_not_be_zero"]),
        (pid_max, _TS["pending_id_must_not_be_int_max"]),
        (u128.eq(ev["pid_hi"], ev["pid_lo"], ev["id_hi"], ev["id_lo"]),
         _TS["pending_id_must_be_different"]),
        (ev["timeout"] != 0, _TS["timeout_reserved_for_pending_transfer"]),
        (~p_found, _TS["pending_transfer_not_found"]),
        (~_flag(p["flags"], _F_PENDING), _TS["pending_transfer_not_pending"]),
        ((~u128.is_zero(ev["dr_hi"], ev["dr_lo"]))
         & ~u128.eq(ev["dr_hi"], ev["dr_lo"], p["dr_hi"], p["dr_lo"]),
         _TS["pending_transfer_has_different_debit_account_id"]),
        ((~u128.is_zero(ev["cr_hi"], ev["cr_lo"]))
         & ~u128.eq(ev["cr_hi"], ev["cr_lo"], p["cr_hi"], p["cr_lo"]),
         _TS["pending_transfer_has_different_credit_account_id"]),
        ((ev["ledger"] != 0) & (ev["ledger"] != p["ledger"]),
         _TS["pending_transfer_has_different_ledger"]),
        ((ev["code"] != 0) & (ev["code"] != p["code"]),
         _TS["pending_transfer_has_different_code"]),
        (u128.lt(p["amt_hi"], p["amt_lo"], pv_amt_hi, pv_amt_lo),
         _TS["exceeds_pending_transfer_amount"]),
        (is_void & u128.lt(pv_amt_hi, pv_amt_lo, p["amt_hi"], p["amt_lo"]),
         _TS["pending_transfer_has_different_amount"]),
        (p["pstat"] == _PS_POSTED, _TS["pending_transfer_already_posted"]),
        (p["pstat"] == _PS_VOIDED, _TS["pending_transfer_already_voided"]),
        (p["pstat"] == _PS_EXPIRED, _TS["pending_transfer_expired"]),
        (p_expires_due, _TS["pending_transfer_expired"]),
        (_flag(p_dr["flags"], _A_CLOSED) & ~is_void,
         _TS["debit_account_already_closed"]),
        (_flag(p_cr["flags"], _A_CLOSED) & ~is_void,
         _TS["credit_account_already_closed"]),
    ]
    # A use whose in-batch definition turns out dead: the pending
    # transfer does not exist, so earlier-precedence field checks still
    # win and the rest reads pending_transfer_not_found.
    pv_status_nf = _first_failure(
        pv_checks[:6] + [(torch.ones_like(pid_zero),
                          _TS["pending_transfer_not_found"])])
    return _first_failure(pv_checks), pv_status_nf, pv_amt_hi, pv_amt_lo


def per_event_status(state, ev, ts_event, inwin=None, didx=None,
                     imported_ctx=None):
    """The per-event phase of create_transfers: hash lookups, row gathers
    and the order-independent status evaluation (exists/idempotency,
    post/void checks, regular checks — reference create_transfer
    :3719-3904 minus running-balance effects). Both hash probes go
    through the fused probe kernel. Statuses here are not valid-masked;
    the caller applies the mask after chain handling. The row gathers
    (dr, cr, p, p_dr, p_cr) come back under '_gathers' for reuse.

    inwin/didx (fixpoint tiers): the in-batch pending join. A use whose
    pid matches an EARLIER in-batch definition reads the pending
    transfer from the definition's event lanes instead of the table,
    unless the definition's id already exists in the table (live or
    orphaned): then the definition is not created and the table row is
    the sequential-truth target. The outputs then also carry the gated
    inwin, didx and `status_pre_dead` (the status if the definition
    turns out dead). imported_ctx (the imported tier's event rules)
    raises NotImplementedError: it is a later slice of the port."""
    if imported_ctx is not None:
        raise NotImplementedError(
            "per_event_status: imported_ctx is a later slice of the port "
            "(the imported/balancing/closing slice)")
    acc = state["accounts"]
    xfr = state["transfers"]
    A_dump = acc["u64"].shape[0] - 1
    T_dump = xfr["u64"].shape[0] - 1

    flags = ev["flags"]
    pending = _flag(flags, _F_PENDING)
    pv = _flag(flags, _F_POST) | _flag(flags, _F_VOID)

    # ---------------- lookups ----------------
    # Both tables in one probe launch, each over its concatenated key
    # sets: the account table at the dr then cr keys, the transfer table
    # at the id then pid keys. The transfer table carries orphaned
    # (transiently failed) ids inline with val = ORPHAN_VAL, so one probe
    # of the event id answers both exists and already-failed (reference
    # id_already_failed, src/state_machine.zig:3734).
    N_ev = ev["id_lo"].shape[0]
    (a_found, a_row), (x_found, x_val) = ht_lookup_fused_multi((
        (state["acct_ht"],
         torch.cat([ev["dr_hi"], ev["cr_hi"]]),
         torch.cat([ev["dr_lo"], ev["cr_lo"]])),
        (state["xfer_ht"],
         torch.cat([ev["id_hi"], ev["pid_hi"]]),
         torch.cat([ev["id_lo"], ev["pid_lo"]]))))
    dr_found, cr_found = a_found[:N_ev], a_found[N_ev:]
    a_row = a_row.to(torch.int64)
    dr_row, cr_row = a_row[:N_ev], a_row[N_ev:]
    x_val = x_val.to(torch.int64)
    live = x_val >= 0
    e_found = x_found[:N_ev] & live[:N_ev]
    o_found = x_found[:N_ev] & ~live[:N_ev]
    # A pid pointing at an orphaned id is "pending transfer not found".
    p_found = x_found[N_ev:] & live[N_ev:]
    e_row, p_row = x_val[:N_ev], x_val[N_ev:]

    dr_rowc = torch.where(dr_found, dr_row, A_dump)
    cr_rowc = torch.where(cr_found, cr_row, A_dump)
    e_rowc = torch.where(e_found, e_row, T_dump)
    p_rowc = torch.where(p_found, p_row, T_dump)

    e, p = _xfer_gather_multi(xfr, [e_rowc, p_rowc])

    if inwin is not None:
        # Def-side table-collision gate: one packed-u8 gather for both
        # probe lanes.
        eo = e_found.to(torch.uint8) | (o_found.to(torch.uint8) << 1)
        inwin = inwin & (eo[didx] == 0)
        p2 = _inwin_def_view(ev, ts_event, didx, dr_rowc, cr_rowc)
        p = {k: torch.where(inwin, p2[k], v) for k, v in p.items()}
        p_found = p_found | inwin

    dr, cr, p_dr, p_cr = _acct_gather_multi(
        acc, [dr_rowc, cr_rowc, p["dr_row"], p["cr_row"]],
        [dr_found, cr_found, p_found, p_found])

    # ---------------- status evaluation ----------------
    exists_status, exists_ts = _ct_eval_exists(ev, e, p)

    imported = _flag(flags, _F_IMPORTED)
    pv_status, pv_status_nf, pv_amt_hi, pv_amt_lo = _pv_eval(
        ev, p, p_found, p_dr, p_cr, ts_event)
    amt_res_hi = torch.where(pv, pv_amt_hi, ev["amt_hi"])
    amt_res_lo = torch.where(pv, pv_amt_lo, ev["amt_lo"])

    pid_zero = u128.is_zero(ev["pid_hi"], ev["pid_lo"])
    timeout_ns = ev["timeout"] * NS_PER_S
    ovf_timeout = ugt(ts_event + timeout_ns, U63_MAX)
    reg_checks = [
        (u128.is_zero(ev["dr_hi"], ev["dr_lo"]),
         _TS["debit_account_id_must_not_be_zero"]),
        (u128.is_max(ev["dr_hi"], ev["dr_lo"]),
         _TS["debit_account_id_must_not_be_int_max"]),
        (u128.is_zero(ev["cr_hi"], ev["cr_lo"]),
         _TS["credit_account_id_must_not_be_zero"]),
        (u128.is_max(ev["cr_hi"], ev["cr_lo"]),
         _TS["credit_account_id_must_not_be_int_max"]),
        (u128.eq(ev["dr_hi"], ev["dr_lo"], ev["cr_hi"], ev["cr_lo"]),
         _TS["accounts_must_be_different"]),
        (~pid_zero, _TS["pending_id_must_be_zero"]),
        (~pending & (ev["timeout"] != 0),
         _TS["timeout_reserved_for_pending_transfer"]),
        # reference :3761-3763 — inside the same !pending block as the
        # timeout check, before ledger/code.
        (~pending & _flag(flags, _F_CLOSE_DR | _F_CLOSE_CR),
         _TS["closing_transfer_must_be_pending"]),
        (ev["ledger"] == 0, _TS["ledger_must_not_be_zero"]),
        (ev["code"] == 0, _TS["code_must_not_be_zero"]),
        (~dr["exists"], _TS["debit_account_not_found"]),
        (~cr["exists"], _TS["credit_account_not_found"]),
        (dr["ledger"] != cr["ledger"],
         _TS["accounts_must_have_the_same_ledger"]),
        (ev["ledger"] != dr["ledger"],
         _TS["transfer_must_have_the_same_ledger_as_accounts"]),
        (_flag(dr["flags"], _A_CLOSED), _TS["debit_account_already_closed"]),
        (_flag(cr["flags"], _A_CLOSED), _TS["credit_account_already_closed"]),
        (ovf_timeout, _TS["overflows_timeout"]),
    ]
    reg_status = _first_failure(reg_checks)

    pre = _first_failure([
        ((flags & _TF_PADDING) != 0, _TS["reserved_flag"]),
        (u128.is_zero(ev["id_hi"], ev["id_lo"]), _TS["id_must_not_be_zero"]),
        (u128.is_max(ev["id_hi"], ev["id_lo"]),
         _TS["id_must_not_be_int_max"]),
    ])

    def wrap(pv_branch):
        """The status with the given post/void branch, wrapped in the
        exists / orphan / pre-check / timestamp / imported rules; returns
        (status, inner)."""
        inner = torch.where(
            e_found, exists_status,
            torch.where(o_found, _TS["id_already_failed"],
                        torch.where(pv, pv_branch, reg_status)))
        inner = torch.where(pre != _CREATED, pre, inner)
        status = torch.where(~imported & (ev["ts"] != 0),
                             _TS["timestamp_must_be_zero"], inner)
        # Imported batches fall back (E1) before these statuses can
        # matter; an imported flag here is always a mismatch (reference
        # execute_create :3052-3063).
        status = torch.where(imported, _TS["imported_event_not_expected"],
                             status)
        return status, inner

    status, inner = wrap(pv_status)
    ts_inner = torch.where(e_found & (inner == _TS["exists"]), exists_ts,
                           ts_event)
    ts_actual = torch.where(status == inner, ts_inner, ts_event)

    # Closed-check-stripped status (the fixpoint tiers re-derive the
    # already_closed decisions per round against the EVOLVING in-batch
    # closed state). First-failure structure makes the strip local:
    # already_closed comes only from the regular tail (where the one
    # check after it is overflows_timeout) or the post/void tail (last).
    is_closed_st = ((status == _TS["debit_account_already_closed"])
                    | (status == _TS["credit_account_already_closed"]))
    status_nc = torch.where(
        is_closed_st & ~pv & ovf_timeout, _TS["overflows_timeout"],
        torch.where(is_closed_st, _CREATED, status))
    out = dict(
        status_pre=status, ts_pre=ts_actual, status_nc=status_nc,
        amt_res_hi=amt_res_hi, amt_res_lo=amt_res_lo,
        dr_row=dr_rowc, cr_row=cr_rowc, p_row=p_rowc,
        dr_found=dr_found, cr_found=cr_found, p_found=p_found,
        _gathers=(dr, cr, p, p_dr, p_cr),
    )
    if inwin is not None:
        out["inwin"] = inwin
        out["didx"] = didx
        out["status_pre_dead"] = wrap(pv_status_nf)[0]
    return out


def _later_slices(per_event, seg, ring_reset, imported_mode,
                  balancing_mode):
    later = [
        (per_event is not None,
         "per_event (the spmd join of the parallel/ slice)"),
        (seg is not None, "seg (the superbatch and window-chain slice)"),
        (ring_reset, "ring_reset (the superbatch and window-chain slice)"),
        (imported_mode, "imported_mode (the imported/balancing/closing "
                        "slice)"),
        (balancing_mode, "balancing_mode (the imported/balancing/closing "
                         "slice)"),
    ]
    for bad, what in later:
        if bad:
            raise NotImplementedError(
                f"create_transfers_fast: {what} is a later slice of the "
                "port; this slice runs the plain and limit fixpoint tiers")


def _ts_events(timestamp, n, N, device):
    """Per-event commit timestamps timestamp - n + i + 1 (u64 wrap)."""
    base = s64(int(timestamp) - int(n) + 1)
    return torch.arange(N, dtype=torch.int64, device=device) + base


def _fixpoint_rounds(K, status, status_dead, inwin, didx, linked, valid,
                     idxs, n, N, pv, pending, is_post, is_void, flags,
                     cand_dr, cand_cr, cand_close, cdr_ln, ccr_ln, alx,
                     al2_s, nl2_s, fs):
    """The K-round status fixpoint of the limit tiers (reference: the
    exceeds_credits/debits checks read the balances of every SUCCESSFUL
    earlier event, src/state_machine.zig:3903-3904; closed state
    :3837/:3941-3944/:4184-4189/:4254-4261). Start optimistic; each
    round re-derives chains, in-batch pending deaths, the applied set,
    the closed state and exact per-event PRE-event balances (segmented
    exclusive prefix sums over the status-independent sort `fs`), then
    re-evaluates the limit and closed checks. Each round fixes at least
    the earliest event whose status disagrees with the sequential truth,
    so K rounds resolve any cascade shallower than K. Deaths fold into
    the same round's apply set (Gauss-Seidel), so one round advances a
    full over -> death -> lost-relief wave.

    A static loop of K rounds: an early exit would need a host sync per
    round and changes no result. Returns (over_dr, over_cr, cdr_ln,
    ccr_ln, dead, fix_converged, fix_rounds)."""
    dev = status.device
    close_dr_f = _flag(flags, _F_CLOSE_DR)
    close_cr_f = _flag(flags, _F_CLOSE_CR)
    over_dr = torch.zeros_like(valid)
    over_cr = torch.zeros_like(valid)
    dead = torch.zeros_like(valid)
    fix_converged = torch.ones((), dtype=torch.bool, device=dev)
    fix_rounds = torch.zeros((), dtype=torch.int64, device=dev)
    excl_head = torch.full((1,), -1, dtype=torch.int64, device=dev)
    for rnd in range(K):
        # Round 0 always runs; a later round counts only when the
        # previous one had not converged.
        fix_rounds = fix_rounds + (1 if rnd == 0
                                   else (~fix_converged).to(torch.int64))
        st_r = torch.where(over_dr, _TS["exceeds_credits"], status)
        st_r = torch.where(over_cr & ~over_dr, _TS["exceeds_debits"], st_r)
        # The closed codes precede the limit codes sequentially (:3837
        # before :3904): applied after, so they win; dr before cr.
        st_r = torch.where(cdr_ln, _TS["debit_account_already_closed"],
                           st_r)
        st_r = torch.where(ccr_ln & ~cdr_ln,
                           _TS["credit_account_already_closed"], st_r)
        # In-batch deaths from the PREVIOUS round: a use whose
        # definition did not create reads pending_transfer_not_found.
        st_r = torch.where(dead, status_dead, st_r)
        _, _, my_first_r, in_chain_r = _chain_pass(
            st_r, linked, valid, idxs, n, N)
        # Definition liveness at the use's execution point: dead iff it
        # failed on its own (-1) or its chain broke STRICTLY BEFORE the
        # use (the chain's first-failure position), else +INF.
        dead_enc = torch.where(
            st_r != _CREATED, -1,
            torch.where(in_chain_r, my_first_r, _INF))
        new_dead = inwin & (dead_enc[didx] < idxs)
        # Gauss-Seidel fold: apply the NEW deaths to this round's apply
        # set. At a fixpoint new_dead == dead and the fold is an
        # identity.
        st_f = torch.where(new_dead & ~dead, status_dead, st_r)
        st_c, _, _, _ = _chain_pass(st_f, linked, valid, idxs, n, N)
        ap_r = valid & (st_c == _CREATED)
        mask8 = _apply_mask8(ap_r, pv, pending, is_post, is_void,
                             close_dr_f, close_cr_f, fs["p_cl_dr"],
                             fs["p_cl_cr"])
        m_s = torch.cat([mask8, mask8])[fs["perm"]]
        # Closed state per entry: the latest applied set/clear op
        # strictly before it in its account segment (segmented exclusive
        # running max over op positions), else the pre-batch flag.
        set_s, clr_s = _closed_ops(m_s, fs["cr_side"])
        op_pos = torch.where(set_s | clr_s, fs["idx2"], -1)
        excl_op = torch.cat([excl_head, _cummax(op_pos)[:-1]])
        has_prev = excl_op >= fs["seg_start"]
        closed_pre_s = torch.where(
            has_prev, set_s[torch.clamp(excl_op, min=0)],
            fs["init_closed"])
        closed_pre = closed_pre_s[fs["inv"]]
        new_cdr = cand_close & closed_pre[:N]
        new_ccr = cand_close & closed_pre[N:]
        fls = _sorted_lanes(m_s, fs["cr_side"], al2_s, nl2_s)
        fcs = _cumsum(fls, dim=2)
        foff = torch.where(
            fs["seg_start"] > 0,
            fcs.index_select(2, torch.clamp(fs["seg_start"] - 1, min=0)),
            0)
        # EXCLUSIVE prefix = pre-event balances (subtract own delta); all
        # lane limbs < 2^32, prefixes < 2^45: carry-safe.
        pre = torch.stack(
            _normalize_limbs(fs["base"] + fcs - foff - fls), dim=1)
        pre_ev = pre[:, :, fs["inv"]]
        pre_dr = pre_ev[:, :, :N]
        pre_cr = pre_ev[:, :, N:]

        def over(pre_evt, held1, held2, against):
            # (held1_pre + held2_pre + amount) > against_pre, 5 limbs.
            h1, h2, ag = _FI[held1], _FI[held2], _FI[against]
            lft = [pre_evt[h1, j] + pre_evt[h2, j] + alx[j]
                   for j in range(4)]
            return _u128_over(*lft,
                              pre_evt[ag, 2] | (pre_evt[ag, 3] << 32),
                              pre_evt[ag, 0] | (pre_evt[ag, 1] << 32))

        new_over_dr = cand_dr & over(pre_dr, "dp", "dpos", "cpos")
        new_over_cr = cand_cr & over(pre_cr, "cp", "cpos", "dpos")
        fix_converged = torch.all((new_over_dr == over_dr)
                                  & (new_over_cr == over_cr)
                                  & (new_dead == dead)
                                  & (new_cdr == cdr_ln)
                                  & (new_ccr == ccr_ln))
        over_dr, over_cr, dead = new_over_dr, new_over_cr, new_dead
        cdr_ln, ccr_ln = new_cdr, new_ccr
    return over_dr, over_cr, cdr_ln, ccr_ln, dead, fix_converged, fix_rounds


def create_transfers_fast(state, ev, timestamp, n, force_fallback=None,
                          per_event=None, limit_rounds=1, seg=None,
                          ring_reset=False, imported_mode=False,
                          balancing_mode=False):
    """One batch against the device ledger. Returns (state, out) with
    out = {r_status, r_ts, fallback, limit_only, fb_causes,
    fix_unconverged, fix_rounds, limit_hit, created_count}.
    `state` is updated in place; when out['fallback'] is set, the live
    state is unchanged.

    limit_rounds: 1 = the plain tier (balance limits gated behind the
    worst-case headroom proof; out['limit_only'] marks a fallback whose
    only causes the fixpoint tiers resolve); K > 1 = the limit fixpoint
    tier of K rounds (out['fix_unconverged'] marks a fallback whose only
    cause is a cascade deeper than K). out['limit_hit'] is the headroom
    proof's outcome on either tier; out['fix_rounds'] the rounds the
    fixpoint consumed (0 on the plain tier).

    timestamp/n: Python ints (the prepare timestamp and the batch's real
    event count). force_fallback: optional bool tensor that aborts the
    batch unconditionally. per_event (the spmd join), seg, ring_reset,
    imported_mode and balancing_mode raise NotImplementedError naming the
    later slice that brings them."""
    _later_slices(per_event, seg, ring_reset, imported_mode,
                  balancing_mode)
    fixpoint = limit_rounds > 1
    acc = state["accounts"]
    xfr = state["transfers"]
    evr = state["events"]
    dev = acc["u64"].device
    N = ev["id_lo"].shape[0]
    A_rows = acc["u64"].shape[0]
    A_dump = A_rows - 1
    T_dump = xfr["u64"].shape[0] - 1
    idxs = torch.arange(N, dtype=torch.int64, device=dev)
    valid = ev["valid"]
    ts_event = _ts_events(timestamp, n, N, dev)

    flags = ev["flags"]
    linked = _flag(flags, _F_LINKED) & valid
    pending = _flag(flags, _F_PENDING)
    is_post = _flag(flags, _F_POST)
    is_void = _flag(flags, _F_VOID)
    pv = is_post | is_void
    timeout_ns = ev["timeout"] * NS_PER_S

    if fixpoint:
        # The precise dup/join split + the in-batch pending substitution.
        e2, inwin_raw, didx = _dup_and_pend_join(ev, valid, pv, idxs, N)
        per_event = per_event_status(state, ev, ts_event, inwin=inwin_raw,
                                     didx=didx)
        inwin = per_event["inwin"]
        status_dead = per_event["status_pre_dead"]
        # Closing is native on every fixpoint tier: the base status is
        # the closed-stripped variant; the rounds re-derive the closed
        # codes from the evolving in-batch closed state.
        status = per_event["status_nc"]
    else:
        # The combined collision check: any collision (a same-kind
        # duplicate or an in-batch pending reference) escalates to the
        # fixpoint tier.
        e2 = _combined_dup_keys(ev, valid, pv)
        per_event = per_event_status(state, ev, ts_event)
        status = per_event["status_pre"]
    dr_rowc = per_event["dr_row"]
    cr_rowc = per_event["cr_row"]
    p_rowc = per_event["p_row"]
    p_found = per_event["p_found"]
    amt_res_hi = per_event["amt_res_hi"]
    amt_res_lo = per_event["amt_res_lo"]
    ts_actual = per_event["ts_pre"]
    dr, cr, p, p_dr, p_cr = per_event["_gathers"]

    # ---------------- eligibility ----------------
    # E1: imported and balancing flags are hard. Closing flags (and, E5,
    # voids of closing pendings) escalate on the plain tier and run
    # natively on the fixpoint tiers.
    e1_vec = valid & _flag(flags, _F_IMPORTED | _F_BAL_DR | _F_BAL_CR)
    e_close_vec = (torch.zeros_like(valid) if fixpoint
                   else valid & _flag(flags, _F_CLOSE_DR | _F_CLOSE_CR))

    # Proof sums run over the optimistic apply set: an event whose
    # per-event status already failed can never apply (the fixpoint only
    # flips events within this set toward failure).
    opt = valid & (status == _CREATED)

    # E3 (headroom proof): every balance-limited account must fit the
    # batch's worst-case load (all candidate amounts against it, no
    # mid-batch relief) in its pre-batch headroom; then no prefix order
    # can trip exceeds_credits/debits.
    reg = opt & ~pv
    ral = torch.stack(_to_limbs(torch.where(reg, amt_res_hi, 0),
                                torch.where(reg, amt_res_lo, 0)), dim=1)
    aflags_full = srl(acc["u64"][:, _AC_CF_COL], 32)
    # The dump row is scratch and must never latch a breach.
    not_dump = torch.arange(A_rows, device=dev) != A_dump

    def _breach(load, held1, held2, against1, limit_bit):
        balm = acc["bal"]
        h1, h2, ag = BAL_IDX[held1], BAL_IDX[held2], BAL_IDX[against1]
        lft = [balm[:, h1 + j] + balm[:, h2 + j] + load[j]
               for j in range(4)]
        over = _u128_over(*lft,
                          balm[:, ag + 2] | (balm[:, ag + 3] << 32),
                          balm[:, ag] | (balm[:, ag + 1] << 32))
        return _flag(aflags_full, limit_bit) & not_dump & over

    # ONE segment sum covers both sides' worst-case loads (credit rows
    # offset by A_rows); integer index_add_ is deterministic.
    rows2l = torch.cat([dr_rowc, cr_rowc + A_rows])
    s2 = torch.zeros((2 * A_rows, 4), dtype=torch.int64, device=dev)
    s2.index_add_(0, rows2l, torch.cat([ral, ral]))
    e3 = torch.any(torch.stack([
        _breach([s2[:A_rows, j] for j in range(4)],
                "dp", "dpos", "cpos", _A_DR_LIMIT),
        _breach([s2[A_rows:, j] for j in range(4)],
                "cp", "cpos", "dpos", _A_CR_LIMIT)]))
    # The proof's outcome survives the fixpoint override below: the
    # ledger drops back to the plain tier only once the proof would pass.
    proof_breach = e3
    fix_rounds = torch.zeros((), dtype=torch.int64, device=dev)

    # E4: no u128 balance overflow is possible — max touched pair sum
    # (dp+dpos, cp+cpos) plus the exact 160-bit sum S of all batch
    # amounts stays below 2^128 (reference :3856-3884).
    a_hi = torch.where(opt, amt_res_hi, 0)
    a_lo = torch.where(opt, amt_res_lo, 0)
    s0, s1, s2_, s3 = torch.sum(torch.stack(_to_limbs(a_hi, a_lo)), dim=1)
    c = srl(s0, 32)
    s0 = s0 & M32
    s1 = s1 + c
    c = srl(s1, 32)
    s1 = s1 & M32
    s2_ = s2_ + c
    c = srl(s2_, 32)
    s2_ = s2_ & M32
    s3 = s3 + c
    s4 = srl(s3, 32)
    s3 = s3 & M32
    s_hi = s2_ | (s3 << 32)
    s_lo = s0 | (s1 << 32)
    pair_his, pair_los, pair_ovfs = [], [], []
    for acct_g in (dr, cr, p_dr, p_cr):
        for f1, f2 in (("dp", "dpos"), ("cp", "cpos")):
            h, l, o = u128.add(acct_g[f1][0], acct_g[f1][1],
                               acct_g[f2][0], acct_g[f2][1])
            pair_his.append(torch.where(opt, h, 0))
            pair_los.append(torch.where(opt, l, 0))
            pair_ovfs.append(opt & o)
    m_hi, m_lo = _u128_max_reduce(pair_his, pair_los)
    _, _, ovf = u128.add(m_hi, m_lo, s_hi, s_lo)
    e5_vec = (valid & is_void & p_found
              & _flag(p["flags"], _F_CLOSE_DR | _F_CLOSE_CR))
    hard_any = torch.any(torch.stack([e1_vec, *pair_ovfs]))
    e145 = hard_any | ovf | (s4 > 0)

    if fixpoint:
        # ---- the status-independent sorted entry space of the rounds
        # (and of the application below): every valid event's two
        # account sides, sorted by (row, event order).
        fs = {}
        alx = _to_limbs(amt_res_hi, amt_res_lo)
        nlx = _neg_limbs(p["amt_hi"], p["amt_lo"])
        frows2 = torch.cat([
            torch.where(valid, torch.where(pv, p["dr_row"], dr_rowc),
                        A_dump),
            torch.where(valid, torch.where(pv, p["cr_row"], cr_rowc),
                        A_dump),
        ])
        fperm = _packed_perm(frows2, torch.cat([idxs, idxs]), A_rows)
        frows_sorted = frows2[fperm]
        fstart = torch.cat([
            torch.ones(1, dtype=torch.bool, device=dev),
            frows_sorted[1:] != frows_sorted[:-1]])
        idx2 = torch.arange(2 * N, dtype=torch.int64, device=dev)
        # Per-entry segment-start position: a forward fill of start
        # positions (one running max; start positions increase).
        fs["seg_start"] = _cummax(torch.where(fstart, idx2, -1))
        fs["inv"] = torch.empty(2 * N, dtype=torch.int64, device=dev)
        fs["inv"][fperm] = idx2
        fs["perm"] = fperm
        fs["idx2"] = idx2
        fs["cr_side"] = fperm >= N
        fs["base"] = row_gather(acc["bal"], frows_sorted).T.reshape(
            4, 4, 2 * N)
        # Round-static sorted amount limbs: each round gathers only the
        # packed u8 apply mask.
        al2_s = [torch.cat([alx[j], alx[j]])[fperm] for j in range(4)]
        nl2_s = [torch.cat([nlx[j], nlx[j]])[fperm] for j in range(4)]
        cand_dr = (valid & ~pv & _flag(dr["flags"], _A_DR_LIMIT)
                   & (status == _CREATED))
        cand_cr = (valid & ~pv & _flag(cr["flags"], _A_CR_LIMIT)
                   & (status == _CREATED))
        # Closed-check candidates: the check is reachable iff every
        # earlier-precedence check passed — the stripped status is
        # CREATED or a code after the closed position (regular:
        # overflows_timeout; post/void: none). Voids are exempt
        # (:4184-4189).
        cand_close = valid & (
            (~pv & ((status == _CREATED)
                    | (status == _TS["overflows_timeout"])))
            | (pv & is_post & (status == _CREATED)))
        # One gather of the packed (code|flags) column serves the round-0
        # closed view and the application's flag write-back (which keeps
        # the code half).
        cf_s = acc["u64"][frows_sorted, _AC_CF_COL]
        base_flags_s = srl(cf_s, 32)
        fs["init_closed"] = _flag(base_flags_s, _A_CLOSED)
        fs["p_cl_dr"] = _flag(p["flags"], _F_CLOSE_DR)
        fs["p_cl_cr"] = _flag(p["flags"], _F_CLOSE_CR)
        # Round 0: the pre-batch closed flags (the per-event gathers).
        cdr_ln = cand_close & _flag(
            torch.where(pv, p_dr["flags"], dr["flags"]), _A_CLOSED)
        ccr_ln = cand_close & _flag(
            torch.where(pv, p_cr["flags"], cr["flags"]), _A_CLOSED)
        (over_dr, over_cr, cdr_ln, ccr_ln, dead, fix_converged,
         fix_rounds) = _fixpoint_rounds(
            limit_rounds, status, status_dead, inwin, didx, linked, valid,
            idxs, n, N, pv, pending, is_post, is_void, flags, cand_dr,
            cand_cr, cand_close, cdr_ln, ccr_ln, alx, al2_s, nl2_s, fs)
        status = torch.where(over_dr, _TS["exceeds_credits"], status)
        status = torch.where(over_cr & ~over_dr, _TS["exceeds_debits"],
                             status)
        status = torch.where(cdr_ln, _TS["debit_account_already_closed"],
                             status)
        status = torch.where(ccr_ln & ~cdr_ln,
                             _TS["credit_account_already_closed"], status)
        status = torch.where(dead, status_dead, status)
        e3 = ~fix_converged

    # ---------------- chains: segment first-failure broadcast ----------------
    status, not_the_failure, my_first, in_chain = _chain_pass(
        status, linked, valid, idxs, n, N)
    ts_actual = torch.where(not_the_failure, ts_event, ts_actual)

    status = torch.where(valid, status, 0)
    created = valid & (status == _CREATED)
    # Events applied then rolled back by a chain break: their pulse_next
    # updates survive the rollback (the oracle's _Scope note).
    applied_ever = created | (
        in_chain & valid & (status == _TS["linked_event_failed"])
        & (idxs < my_first))

    # ------- commit/abort decision (read-only planning) -------
    # Every fallback cause is resolved before any state write, so the
    # abort path is "mask every scatter to the dump rows".
    created_i = created.to(torch.int64)
    row_off = _cumsum(created_i) - created_i
    n_created = torch.sum(created_i)
    xcount = xfr["count"].to(torch.int64)
    new_rows = xcount + row_off

    e7 = (xcount + n_created) > T_dump
    ring_base = evr["count"].to(torch.int64)
    e8 = (ring_base + n_created) > ev_cap(evr)

    transient = torch.zeros_like(valid)
    for code in _TRANSIENT_CODES:
        transient = transient | (status == code)
    orphan_new = valid & transient

    # Created rows and new orphans are disjoint id sets in the same
    # table (orphans carry ORPHAN_VAL): one plan + one write.
    ins_mask = created | orphan_new
    xfer_pos, ins_ok = ht_plan(
        state["xfer_ht"], ev["id_hi"], ev["id_lo"], ins_mask)

    if fixpoint:
        # e2 is precise same-kind duplicates (a real fallback); only an
        # unconverged cascade escalates (to the deeper tier).
        others = e145 | e2 | e7 | e8 | ~ins_ok
        escalatable = e3
    else:
        others = e145 | e7 | e8 | ~ins_ok
        escalatable = (e3 | e2
                       | torch.any(torch.stack([e_close_vec, e5_vec])))
    if force_fallback is not None:
        others = others | force_fallback
    fallback = others | escalatable
    limit_only = escalatable & ~others & (not fixpoint)
    ok = ~fallback

    # ---------------- application (all masked by ok) ----------------
    ap = created & ok
    ap_pv = ap & pv

    al = _to_limbs(amt_res_hi, amt_res_lo)
    nl = _neg_limbs(p["amt_hi"], p["amt_lo"])

    # Insert created transfer rows (compacted); the pending-status flips
    # run after the insert. An in-batch use flips the row its definition
    # inserts in this batch (trow[didx]). Masked lanes write uniform
    # zeros to the dump row, so the duplicate-index scatters stay
    # deterministic.
    trow = torch.where(ap, new_rows, T_dump)
    flip_row = torch.where(inwin, trow[didx], p_rowc) if fixpoint else p_rowc
    flip_pos = torch.where(ap_pv, flip_row, T_dump)
    ud128z = u128.is_zero(ev["ud128_hi"], ev["ud128_lo"])
    stores = dict(
        id_hi=ev["id_hi"], id_lo=ev["id_lo"],
        dr_hi=torch.where(pv, p["dr_hi"], ev["dr_hi"]),
        dr_lo=torch.where(pv, p["dr_lo"], ev["dr_lo"]),
        cr_hi=torch.where(pv, p["cr_hi"], ev["cr_hi"]),
        cr_lo=torch.where(pv, p["cr_lo"], ev["cr_lo"]),
        amt_hi=amt_res_hi, amt_lo=amt_res_lo,
        pid_hi=ev["pid_hi"], pid_lo=ev["pid_lo"],
        ud128_hi=torch.where(pv & ud128z, p["ud128_hi"], ev["ud128_hi"]),
        ud128_lo=torch.where(pv & ud128z, p["ud128_lo"], ev["ud128_lo"]),
        ud64=torch.where(pv & (ev["ud64"] == 0), p["ud64"], ev["ud64"]),
        ud32=torch.where(pv & (ev["ud32"] == 0), p["ud32"], ev["ud32"]),
        timeout=torch.where(pv, 0, ev["timeout"]),
        ledger=torch.where(pv, p["ledger"], ev["ledger"]),
        code=torch.where(pv, p["code"], ev["code"]),
        flags=flags,
        ts=ts_actual,
        pstat=torch.where(pending & ~pv, _PS_PENDING, 0),
        expires=torch.where(pending & ~pv & (ev["timeout"] != 0),
                            ts_actual + timeout_ns, 0),
        dr_row=torch.where(pv, p["dr_row"], dr_rowc),
        cr_row=torch.where(pv, p["cr_row"], cr_rowc),
    )
    u64_rows = torch.stack(
        [stores[k] for k in XF_U64]
        + [pack32(stores[pr[0]], stores[pr[1]] if len(pr) > 1 else None)
           for pr in XF_P32],
        dim=1)

    # ------- account_events history ring (reference: account_event(),
    # src/state_machine.zig:4384-4470 — post-application balance
    # snapshots of both touched accounts per created transfer), computed
    # exactly with a sort + segmented limb prefix sum. The last entry per
    # account row is the post-batch balance, scattered back below.
    E_dump = ev_cap(evr)
    pos2 = torch.arange(2 * N, dtype=torch.int64, device=dev)
    if fixpoint:
        # Reuse the fixpoint's sorted entry space wholesale: its valid
        # mask is a superset of the apply mask, and a valid-but-unapplied
        # entry contributes a ZERO delta, so prefixes and final balances
        # are the same (unapplied accounts rewrite their own limbs). The
        # application is one more round body at the final apply set.
        perm = fs["perm"]
        rows_sorted = frows_sorted
        is_start = fstart
        seg_start = fs["seg_start"]
        inv = fs["inv"]
        base = fs["base"]
        mask8f = _apply_mask8(ap, pv, pending, is_post, is_void,
                              _flag(flags, _F_CLOSE_DR),
                              _flag(flags, _F_CLOSE_CR), fs["p_cl_dr"],
                              fs["p_cl_cr"])
        m_s2 = torch.cat([mask8f, mask8f])[perm]
        lanes_sorted = _sorted_lanes(m_s2, fs["cr_side"], al2_s, nl2_s)
    else:
        ap_reg = ap & ~pv & ~pending
        ap_pend = ap & ~pv & pending
        ap_post = ap_pv & is_post
        side_rows = [
            torch.where(ap, torch.where(pv, p["dr_row"], dr_rowc), A_dump),
            torch.where(ap, torch.where(pv, p["cr_row"], cr_rowc), A_dump),
        ]
        rows2 = torch.cat(side_rows)  # 2N: dr sides then cr sides
        perm = _packed_perm(rows2, torch.cat([idxs, idxs]), A_rows)
        rows_sorted = rows2[perm]
        is_start = torch.cat([
            torch.ones(1, dtype=torch.bool, device=dev),
            rows_sorted[1:] != rows_sorted[:-1]])
        seg_start = _cummax(torch.where(is_start, pos2, -1))
        inv = torch.empty(2 * N, dtype=torch.int64, device=dev)
        inv[perm] = pos2
        # Packed-balance base: one row gather, as [field][limb][entry].
        base = row_gather(acc["bal"], rows_sorted).T.reshape(4, 4, 2 * N)
        lanes2 = _delta_lanes2(ap_reg, ap_pend, ap_pv, ap_post, al, nl)
        lanes_sorted = lanes2[:, :, perm]
    cs = _cumsum(lanes_sorted, dim=2)
    offsets = torch.where(
        seg_start > 0,
        cs.index_select(2, torch.clamp(seg_start - 1, min=0)), 0)
    limbs = base + cs - offsets                       # (4, 4, 2N)
    l0, l1, l2, l3 = _normalize_limbs(limbs)
    hi_sorted = l2 | (l3 << 32)                       # (4, 2N)
    lo_sorted = l0 | (l1 << 32)

    is_final = torch.cat([is_start[1:],
                          torch.ones(1, dtype=torch.bool, device=dev)])
    real = is_final & (rows_sorted != A_dump)
    tgt = torch.where(real, rows_sorted, A_dump)
    vals = torch.stack([l0, l1, l2, l3], dim=1).reshape(16, 2 * N).T
    hilo_all = torch.cat([hi_sorted, lo_sorted])[:, inv]   # (8, 2N)
    snap = {}
    for fi, field in enumerate(_FIELDS):
        snap[f"dr_{field}"] = (hilo_all[fi, :N], hilo_all[4 + fi, :N])
        snap[f"cr_{field}"] = (hilo_all[fi, N:], hilo_all[4 + fi, N:])

    eff_dr_flags = torch.where(pv, p_dr["flags"], dr["flags"])
    eff_cr_flags = torch.where(pv, p_cr["flags"], cr["flags"])
    if fixpoint:
        # ---- closed-flag application + POST-event ring flags: the ring
        # carries each account's flags after the event (reference
        # :3948-3963), the account store the post-batch value. Same
        # last-op-wins scan as the rounds, at the final apply set.
        set2, clr2 = _closed_ops(m_s2, fs["cr_side"])
        incl2 = _cummax(torch.where(set2 | clr2, pos2, -1))
        # In-segment iff the latest op position is at/after the
        # segment's start (the sort is segment-contiguous).
        has2 = incl2 >= seg_start
        closed_incl_s = torch.where(has2, set2[torch.clamp(incl2, min=0)],
                                    fs["init_closed"])
        # Post-batch flag word per account: the last entry of each real
        # segment, written only where the segment carried an op (at a
        # segment's last entry has2 says exactly that), so untouched
        # accounts keep their word; the code half is preserved.
        wrf = real & has2
        new_word = torch.where(closed_incl_s, base_flags_s | _A_CLOSED,
                               base_flags_s & ~_A_CLOSED)
        new_word64 = (cf_s & M32) | (new_word << 32)
        closed_incl = closed_incl_s[inv]
        eff_dr_flags = torch.where(closed_incl[:N], eff_dr_flags | _A_CLOSED,
                                   eff_dr_flags & ~_A_CLOSED)
        eff_cr_flags = torch.where(closed_incl[N:], eff_cr_flags | _A_CLOSED,
                                   eff_cr_flags & ~_A_CLOSED)

    erow = torch.where(ap, ring_base + row_off, E_dump)
    stores_ev = dict(
        ts=ts_actual,
        amt_hi=amt_res_hi, amt_lo=amt_res_lo,
        areq_hi=ev["amt_hi"], areq_lo=ev["amt_lo"],
        tflags=flags,
        pstat=torch.where(pending & ~pv, _PS_PENDING,
                          torch.where(is_post, _PS_POSTED,
                                      torch.where(is_void, _PS_VOIDED, 0))),
        p_row=torch.where(ap_pv, flip_row, -1),
        dr_row=torch.where(pv, p["dr_row"], dr_rowc),
        cr_row=torch.where(pv, p["cr_row"], cr_rowc),
        dr_flags=eff_dr_flags,
        cr_flags=eff_cr_flags,
    )
    for sside in ("dr", "cr"):
        for field in _FIELDS:
            hi_arr, lo_arr = snap[f"{sside}_{field}"]
            stores_ev[f"{sside}_{field}_hi"] = hi_arr
            stores_ev[f"{sside}_{field}_lo"] = lo_arr
    ev_u64_rows = torch.stack(
        [stores_ev[k] for k in EV_U64]
        + [pack32(stores_ev[pr[0]],
                  stores_ev[pr[1]] if len(pr) > 1 else None)
           for pr in EV_P32],
        dim=1)

    # Scalars: both running maxima in one stacked reduce.
    last2 = umax_reduce(torch.where(created[None, :],
                                    torch.stack([ts_event, ts_actual]), 0),
                        dim=1)
    last_ts, last_actual = last2[0], last2[1]
    any_applied = torch.any(created) & ok
    key_max = torch.where(any_applied,
                          umax(state["xfer_key_max"], last_actual),
                          state["xfer_key_max"])
    commit_ts = torch.where(any_applied, last_ts, state["commit_ts"])

    # Pulse scheduling: the exact sequential evolution in closed form
    # (oracle min-update and reset). Per applied event in order, a
    # pending-with-timeout sets pulse = min(pulse, expires); a post/void
    # of a timed pending resets pulse to TIMESTAMP_MIN iff pulse ==
    # expires(p) at that moment. Once a reset fires pulse stays at
    # TIMESTAMP_MIN, and before it the pulse seen by event j is min(P0,
    # prefix-min of earlier mins) — one cummin.
    expires_new = torch.where(
        applied_ever & pending & (ev["timeout"] != 0),
        ts_event + timeout_ns, U64_MAX)
    p0 = state["pulse_next"]
    cm = ucummin(expires_new)
    before_min = torch.cat([
        torch.full((1,), U64_MAX, dtype=torch.int64, device=dev), cm[:-1]])
    run_pulse = umin(p0, before_min)
    applied_pv = applied_ever & pv
    fired = applied_pv & (p["timeout"] != 0) & (p["expires"] == run_pulse)
    pulse = torch.where(torch.any(fired), 1,
                        umin(p0, umin_reduce(expires_new)))
    pulse = torch.where(ok, pulse, state["pulse_next"])

    # ---------------- state writes (in place) ----------------
    xfr["u64"][trow] = torch.where(ap[:, None], u64_rows, 0)
    xfr["u64"][flip_pos, XF_P32_POS["pstat"][0]] = pack32(
        torch.where(ap_pv, torch.where(is_post, _PS_POSTED, _PS_VOIDED), 0))
    xfr["count"] = (xcount + torch.where(ok, n_created, 0)).to(torch.int32)
    ht_write(state["xfer_ht"], xfer_pos, ev["id_hi"], ev["id_lo"],
             torch.where(created, new_rows, ORPHAN_VAL), ins_mask & ok)
    acc["bal"][tgt] = torch.where(real[:, None], vals, 0)
    if fixpoint:
        acc["u64"][torch.where(wrf, rows_sorted, A_dump), _AC_CF_COL] = \
            torch.where(wrf, new_word64, 0)
    evr["u64"][erow] = torch.where(ap[:, None], ev_u64_rows, 0)
    evr["count"] = torch.where(ok, ring_base + n_created,
                               ring_base).to(torch.int32)
    state["xfer_key_max"] = key_max
    state["pulse_next"] = pulse
    state["commit_ts"] = commit_ts

    fb_causes = {
        "e1_hard_flags": torch.any(e1_vec),
        "e2_collision": e2,
        "e3_limit": e3,
        "e4_overflow": torch.any(torch.stack(pair_ovfs)) | ovf | (s4 > 0),
        "e5_void_closing": torch.any(e5_vec),
        "closing": torch.any(e_close_vec),
        "capacity": e7 | e8 | ~ins_ok,
        "forced": (torch.zeros((), dtype=torch.bool, device=dev)
                   if force_fallback is None else force_fallback),
    }
    out = dict(
        r_status=torch.where(ok, status, 0),
        r_ts=torch.where(ok & valid, ts_actual, 0),
        fallback=fallback,
        limit_only=limit_only,
        fb_causes={k: v & fallback for k, v in fb_causes.items()},
        # The fixpoint tiers' only obstacle was a cascade deeper than the
        # round budget: a deeper tier resolves it on the device.
        fix_unconverged=e3 & ~others & fixpoint,
        fix_rounds=fix_rounds,
        limit_hit=proof_breach,
        created_count=torch.where(ok, n_created, 0).to(torch.int32),
    )
    return state, out


def create_transfers_fixpoint(state, ev, timestamp, n, force_fallback=None):
    """The limit fixpoint tier (the JAX package's
    create_transfers_fixpoint_jit without the jit)."""
    return create_transfers_fast(state, ev, timestamp, n, force_fallback,
                                 limit_rounds=LIMIT_FIXPOINT_ROUNDS)


def create_transfers_fixpoint_deep(state, ev, timestamp, n,
                                   force_fallback=None):
    """The deep limit fixpoint tier, the escalation target of an
    unconverged 8-round batch (create_transfers_fixpoint_deep_jit)."""
    return create_transfers_fast(state, ev, timestamp, n, force_fallback,
                                 limit_rounds=LIMIT_FIXPOINT_ROUNDS_DEEP)


# ================================================== create_accounts (fast)

def create_accounts_fast(state, ev, timestamp, n, imported_mode=False):
    """Vectorized create_accounts (reference :3613-3689). Eligibility: no
    imported flag (the imported tier is a later slice), no duplicate ids
    in the batch, capacity suffices. Updates `state` in place; on
    fallback only the dump rows are written."""
    if imported_mode:
        raise NotImplementedError(
            "create_accounts_fast: imported_mode is a later slice of the "
            "port (the imported/balancing/closing slice)")
    acc = state["accounts"]
    dev = acc["u64"].device
    A_dump = acc["u64"].shape[0] - 1
    N = ev["id_lo"].shape[0]
    idxs = torch.arange(N, dtype=torch.int64, device=dev)
    valid = ev["valid"]
    ts_event = _ts_events(timestamp, n, N, dev)

    flags = ev["flags"]
    linked = _flag(flags, _A_LINKED) & valid
    imported = _flag(flags, _A_IMPORTED)

    e_found, e_row = ht_lookup_fused(state["acct_ht"], ev["id_hi"],
                                     ev["id_lo"])
    e_rowc = torch.where(e_found, e_row.to(torch.int64), A_dump)

    e1 = torch.any(valid & imported)
    tag = valid & ~((ev["id_hi"] == 0) & (ev["id_lo"] == 0))
    e2 = _dup_keys(ev["id_hi"], ev["id_lo"], tag)
    fallback_pre = e1 | e2

    # ONE meta row gather: the 32-bit fields unpack from the u64 tail.
    g64 = row_gather(acc["u64"], e_rowc)
    AU = AC_U64_IDX
    g_ul = g64[:, _AC_UL_COL]
    g_cf = g64[:, _AC_CF_COL]
    g_flags = srl(g_cf, 32)
    exists_checks = [
        ((flags & 0xFFFF) != (g_flags & 0xFFFF),
         _AS["exists_with_different_flags"]),
        (~u128.eq(ev["ud128_hi"], ev["ud128_lo"],
                  g64[:, AU["ud128_hi"]], g64[:, AU["ud128_lo"]]),
         _AS["exists_with_different_user_data_128"]),
        (ev["ud64"] != g64[:, AU["ud64"]],
         _AS["exists_with_different_user_data_64"]),
        (ev["ud32"] != (g_ul & M32),
         _AS["exists_with_different_user_data_32"]),
        (ev["ledger"] != srl(g_ul, 32), _AS["exists_with_different_ledger"]),
        (ev["code"] != (g_cf & M32), _AS["exists_with_different_code"]),
    ]
    exists_status = _first_failure(exists_checks, created=_AS["exists"])
    exists_ts = g64[:, AU["ts"]]

    checks = [
        (ev["reserved"] != 0, _AS["reserved_field"]),
        ((flags & _AF_PADDING) != 0, _AS["reserved_flag"]),
        (u128.is_zero(ev["id_hi"], ev["id_lo"]), _AS["id_must_not_be_zero"]),
        (u128.is_max(ev["id_hi"], ev["id_lo"]),
         _AS["id_must_not_be_int_max"]),
        (e_found, 0),  # replaced by exists_status below
        (_flag(flags, _A_DR_LIMIT) & _flag(flags, _A_CR_LIMIT),
         _AS["flags_are_mutually_exclusive"]),
        (~u128.is_zero(ev["dp_hi"], ev["dp_lo"]),
         _AS["debits_pending_must_be_zero"]),
        (~u128.is_zero(ev["dpos_hi"], ev["dpos_lo"]),
         _AS["debits_posted_must_be_zero"]),
        (~u128.is_zero(ev["cp_hi"], ev["cp_lo"]),
         _AS["credits_pending_must_be_zero"]),
        (~u128.is_zero(ev["cpos_hi"], ev["cpos_lo"]),
         _AS["credits_posted_must_be_zero"]),
        (ev["ledger"] == 0, _AS["ledger_must_not_be_zero"]),
        (ev["code"] == 0, _AS["code_must_not_be_zero"]),
    ]
    inner = _first_failure(checks)
    inner = torch.where(inner == 0, exists_status, inner)
    ts_inner = torch.where(inner == _AS["exists"], exists_ts, ts_event)

    status = torch.where(~imported & (ev["ts"] != 0),
                         _AS["timestamp_must_be_zero"], inner)
    status = torch.where(imported, _AS["imported_event_not_expected"],
                         status)
    ts_actual = torch.where(status == inner, ts_inner, ts_event)

    l_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                        linked[:-1]])
    in_chain = linked | l_prev
    start = linked & ~l_prev
    chain_id = _cumsum(start.to(torch.int64))
    chain_open_evt = linked & (idxs == (n - 1))
    status = torch.where(chain_open_evt, _AS["linked_event_chain_open"],
                         status)
    fail = in_chain & valid & (status != _CREATED)
    fail_pos = torch.where(fail, idxs, _INF)
    seg_first = torch.full((N + 1,), _INF, dtype=torch.int64, device=dev)
    seg_first = seg_first.scatter_reduce(0, chain_id, fail_pos, "amin")
    my_first = seg_first[chain_id]
    # The open-chain terminator keeps chain_open even when an earlier
    # member failed (chain_open is applied after chain_broken).
    not_the_failure = (in_chain & (my_first != _INF) & (idxs != my_first)
                       & ~chain_open_evt)
    status = torch.where(not_the_failure, _AS["linked_event_failed"],
                         status)
    ts_actual = torch.where(not_the_failure, ts_event, ts_actual)

    status = torch.where(valid, status, 0)
    created = valid & (status == _CREATED)

    created_i = created.to(torch.int64)
    row_off = _cumsum(created_i) - created_i
    n_created = torch.sum(created_i)
    acount = acc["count"].to(torch.int64)
    e7 = (acount + n_created) > A_dump
    new_rows = acount + row_off
    ht_pos, ins_ok = ht_plan(state["acct_ht"], ev["id_hi"], ev["id_lo"],
                             created)
    fallback = fallback_pre | e7 | ~ins_ok
    ok = ~fallback
    ap = created & ok
    arow = torch.where(ap, new_rows, A_dump)

    named_vals = {"id_hi": ev["id_hi"], "id_lo": ev["id_lo"],
                  "ud128_hi": ev["ud128_hi"], "ud128_lo": ev["ud128_lo"],
                  "ud64": ev["ud64"], "ts": ts_event,
                  "ud32": ev["ud32"], "ledger": ev["ledger"],
                  "code": ev["code"], "flags": flags}
    u64_rows_a = torch.stack(
        [named_vals[k] for k in AC_U64]
        + [pack32(named_vals[pr[0]],
                  named_vals[pr[1]] if len(pr) > 1 else None)
           for pr in AC_P32],
        dim=1)

    last_ts = umax_reduce(torch.where(created, ts_event, 0))
    any_applied = torch.any(created) & ok
    key_max = torch.where(any_applied, umax(state["acct_key_max"], last_ts),
                          state["acct_key_max"])
    commit_ts = torch.where(any_applied, last_ts, state["commit_ts"])

    # ---------------- state writes (in place) ----------------
    # Masked lanes write uniform zero rows to the dump row.
    acc["u64"][arow] = torch.where(ap[:, None], u64_rows_a, 0)
    acc["bal"][arow] = 0
    acc["count"] = (acount + torch.where(ok, n_created, 0)).to(torch.int32)
    ht_write(state["acct_ht"], ht_pos, ev["id_hi"], ev["id_lo"], new_rows,
             ap)
    state["acct_key_max"] = key_max
    state["commit_ts"] = commit_ts

    out = dict(
        r_status=torch.where(ok, status, 0),
        r_ts=torch.where(ok & valid, ts_actual, 0),
        fallback=fallback,
        created_count=torch.where(ok, n_created, 0).to(torch.int32),
    )
    return state, out
