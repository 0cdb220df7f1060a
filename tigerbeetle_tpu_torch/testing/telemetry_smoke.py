"""Device-telemetry smoke: the gate's oracle for the telemetry plane on
the partitioned chain route.

The port's counterpart of the JAX package's `testing/telemetry_smoke.py`.
Four legs, one entry point (``telemetry_smoke(device=None)``):

  1. BIT-EXACT DECODE — one chain call a window on meshes of 1, 2 and 8
     logical shards, and every word of the harvested
     ``shard_stats.tel`` block (decode_telemetry) against a host
     recomputation from the transfer lists and a live-row mirror:
     fixpoint rounds (0 on the plain chain), the priority-encoded poison
     cause (e3_limit at the poisoned prepare, `forced` on the suffix),
     both exchange phases' occupancy and capacity, cross-shard transfer
     counts, per-shard ownership and write-back, and the event ring's
     write-back deltas; then the per-batch escalation replay, whose block
     must show fix_rounds >= 1 and a clean cause.
  2. LANE CENSUS — torchhound.telemetry_census over a traced chain call
     against the committed op budget's `telemetry` section.
  3. NEGATIVE — a pack grown to TEL_WORDS + 1 lanes, traced through the
     same census, must red opbudget.check_telemetry, and the real census
     must pass it.
  4. OVERHEAD RATIO — the chain call's wall time with telemetry on
     against off (the same windows, two states), the median of paired
     ratios (the JAX leg takes the least of 5 reps a side, which one
     slow call on the card's shared host moves past the bound); at or
     below the budget's `overhead_ratio_max`. A clock reading: asserted
     on the card, measured everywhere.

``python -m tigerbeetle_tpu_torch.testing.telemetry_smoke [--device cpu]``.
"""

from __future__ import annotations

import json
import time

import numpy as np

SEED = 41
A_CAP, T_CAP = 1 << 9, 1 << 11
N_ACCTS = 40
SHARDS = (1, 2, 8)   # the decode leg's meshes, the JAX gate's
_CREATED = (1 << 32) - 1  # CreateTransferStatus.created's wire code


def _new_ledger(n_shards, device):
    """Oracle, router and partitioned state on n_shards logical shards of
    `device` (accounts 1..40, ids <= 4 debit-limited: the poison lever)."""
    from ..oracle import StateMachineOracle
    from ..parallel.partitioned import PartitionedRouter
    from ..parallel.shard_utils import Mesh
    from ..types import Account, AccountFlags

    accts = [Account(id=i, ledger=1, code=1,
                     flags=(int(AccountFlags.debits_must_not_exceed_credits)
                            if i <= 4 else 0))
             for i in range(1, N_ACCTS + 1)]
    orc = StateMachineOracle()
    orc.create_accounts(accts, 50)
    rt = PartitionedRouter(Mesh([device] * n_shards), a_cap=A_CAP,
                           t_cap=T_CAP)
    return orc, rt, rt.from_oracle(orc)


class _WindowBuilder:
    """Fresh-id prepares, every (dr, cr) pair on two shards on a mesh of
    several, so the cross-shard word carries a count."""

    def __init__(self, rng, n_shards):
        self.rng = rng
        self.n_shards = n_shards
        self.nid = 10 ** 6
        self.ts = 10 ** 9

    def _pairs(self, count):
        from ..parallel.shard_utils import shard_of_int

        # Clean prepares never debit a limited account (ids <= 4), so the
        # poison causes are exactly the injected ones.
        out = []
        drs, crs = list(range(5, N_ACCTS + 1)), list(range(1, N_ACCTS + 1))
        while len(out) < count:
            dr = int(self.rng.choice(drs))
            cr = int(self.rng.choice(crs))
            if cr != dr and (
                    self.n_shards == 1
                    or shard_of_int(dr, self.n_shards)
                    != shard_of_int(cr, self.n_shards)):
                out.append((dr, cr))
        return out

    def prepare(self, n=8, poison=False, flags=0):
        from ..types import Transfer

        evs = [Transfer(id=self.nid + i, debit_account_id=dr,
                        credit_account_id=cr,
                        amount=int(self.rng.integers(1, 30)), ledger=1,
                        code=1, flags=flags)
               for i, (dr, cr) in enumerate(self._pairs(n))]
        self.nid += n
        if poison:
            # A debit off a debit-limited account beyond its credits: the
            # plain headroom proof falls back limit_only (e3).
            evs.append(Transfer(id=self.nid, debit_account_id=1,
                                credit_account_id=9, amount=10 ** 6,
                                ledger=1, code=1))
            self.nid += 1
        self.ts += 300
        return evs, self.ts

    def closes(self, pendings):
        from ..types import Transfer, TransferFlags as TF

        evs = [Transfer(id=self.nid + i, pending_id=p.id,
                        amount=((1 << 128) - 1) if i % 2 == 0 else 0,
                        flags=int(TF.post_pending_transfer if i % 2 == 0
                                  else TF.void_pending_transfer))
               for i, p in enumerate(pendings)]
        self.nid += len(evs)
        self.ts += 300
        return evs, self.ts


def _expected_words(evs, live, n_pad, n_shards, created_ids):
    """One prepare's telemetry words from its transfers, the live-row
    mirror at entry (id -> (dr, cr) of stored transfers) and the ids the
    prepare created (none for a poisoned or forced prepare)."""
    from ..parallel.shard_utils import shard_of_int

    ids = [int(e.id) for e in evs]
    pids = [int(e.pending_id) for e in evs]
    n_live = len({k for k in ids + pids if k and k in live})
    accts = set()
    for e in evs:
        for a in (int(e.debit_account_id), int(e.credit_account_id)):
            if a:
                accts.add(a)
    for p in pids:
        if p in live:
            accts.update(a for a in live[p] if a)
    owned = [0] * n_shards
    wb = [0] * n_shards
    cross = 0
    for e in evs:
        owned[shard_of_int(int(e.id), n_shards)] += 1
        if int(e.id) in created_ids:
            wb[shard_of_int(int(e.id), n_shards)] += 1
            dr, cr = int(e.debit_account_id), int(e.credit_account_id)
            if shard_of_int(dr, n_shards) != shard_of_int(cr, n_shards):
                cross += 1
    return dict(xchg1_occupancy=n_live, xchg1_capacity=2 * n_pad,
                xchg2_occupancy=len(accts), xchg2_capacity=4 * n_pad,
                cross_shard_transfers=cross, events_owned=owned,
                writeback_transfers=wb)


def _oracle_check(n_shards, device) -> dict:
    """Leg 1: the harvested block of one chain call, word by word,
    against the host recomputation: a clean two-phase window, a window
    poisoned mid-stream, the per-batch fixpoint replay."""
    from ..ops.batch import transfers_to_arrays
    from ..ops.ledger import _pad_bucket, pad_transfer_events
    from ..parallel.partitioned import TEL_CAUSES, _np, decode_telemetry
    from ..types import TransferFlags as TF

    rng = np.random.default_rng(SEED)
    orc, rt, st = _new_ledger(n_shards, device)
    wb_ = _WindowBuilder(rng, n_shards)
    live: dict = {}
    blocks = []

    def commit_oracle(evs, t):
        res = orc.create_transfers(evs, t)
        created = {int(e.id) for e, r in zip(evs, res)
                   if int(r.status) == _CREATED}
        for e in evs:
            if int(e.id) in created:
                live[int(e.id)] = (int(e.debit_account_id),
                                   int(e.credit_account_id))
        return created

    def dispatch(w, tss, n_pad):
        arrays = [transfers_to_arrays(e) for e in w]
        out = rt.chain_dispatch(st, arrays, tss, n_pad)
        tel = _np(out["shard_stats"]["tel"])
        blocks.append(tel.tolist())
        return out, decode_telemetry(tel)

    def check_prepare(d, w, exp, cause_code, clean):
        def rep(name):  # a replicated word: every shard's row agrees
            col = np.asarray(d[name])[:, w]
            assert (col == col.max()).all(), (name, w, col)
            return int(col.max())

        assert rep("fix_rounds") == 0, (w, d["fix_rounds"])
        assert rep("poison_cause") == cause_code, \
            (w, rep("poison_cause"), cause_code)
        for k in ("xchg1_occupancy", "xchg1_capacity",
                  "xchg2_occupancy", "xchg2_capacity"):
            assert rep(k) == exp[k], (w, k, rep(k), exp[k])
        assert rep("exchange_overflow") == 0, w
        assert rep("cross_shard_transfers") == \
            (exp["cross_shard_transfers"] if clean else 0), w
        for s in range(n_shards):
            assert int(d["events_owned"][s, w]) == \
                exp["events_owned"][s], (s, w)
            assert int(d["writeback_transfers"][s, w]) == \
                (exp["writeback_transfers"][s] if clean else 0), (s, w)
            assert int(d["shard_capacity_hit"][s, w]) == 0, (s, w)

    def check_ring(d, wbs):
        # The ring word is cumulative (the count after write-back): its
        # per-prepare deltas must equal the expected write-backs.
        ring = np.asarray(d["ring_occupancy"])
        for s in range(n_shards):
            assert int(ring[s, 0]) >= wbs[0][s], s
            for w in range(1, len(wbs)):
                assert int(ring[s, w]) - int(ring[s, w - 1]) == \
                    wbs[w][s], (s, w, ring[s], wbs)

    # Window A: clean two-phase (pendings, plain, closes); prepare 2's
    # n_live sees prepare 0's pendings through the window's carry.
    p0, t0 = wb_.prepare(flags=int(TF.pending))
    p1, t1 = wb_.prepare()
    p2, t2 = wb_.closes(p0)
    wA, tA = [p0, p1, p2], [t0, t1, t2]
    n_pad = _pad_bucket(max(len(e) for e in wA))
    exps, wbs = [], []
    for evs, t in zip(wA, tA):
        live_before = dict(live)
        created = commit_oracle(evs, t)
        exps.append(_expected_words(evs, live_before, n_pad, n_shards,
                                    created))
        wbs.append(exps[-1]["writeback_transfers"])
    out, d = dispatch(wA, tA, n_pad)
    assert not _np(out["fallback"]).any(), "the clean window fell back"
    for w, exp in enumerate(exps):
        check_prepare(d, w, exp, 0, clean=True)
    check_ring(d, wbs)
    assert exps[2]["xchg1_occupancy"] == len(p0), \
        "the closes prepare must see every pending as a live phase-1 key"

    # Window B: poisoned at prepare 1 (e3 limit cascade); prepare 2
    # carries only the forced poison.
    wB, tB = [], []
    for b in range(3):
        evs, t = wb_.prepare(poison=(b == 1))
        wB.append(evs)
        tB.append(t)
    n_pad_b = _pad_bucket(max(len(e) for e in wB))
    exps_b, wbs_b = [], []
    for b, (evs, t) in enumerate(zip(wB, tB)):
        live_before = dict(live)
        created = commit_oracle(evs, t) if b == 0 else set()
        exps_b.append(_expected_words(evs, live_before, n_pad_b, n_shards,
                                      created))
        wbs_b.append(exps_b[-1]["writeback_transfers"])
    out, d = dispatch(wB, tB, n_pad_b)
    fb = [bool(x) for x in _np(out["fallback"])]
    assert fb == [False, True, True], fb
    e3_code = TEL_CAUSES.index("e3_limit") + 1
    forced_code = TEL_CAUSES.index("forced") + 1
    check_prepare(d, 0, exps_b[0], 0, clean=True)
    check_prepare(d, 1, exps_b[1], e3_code, clean=False)
    check_prepare(d, 2, exps_b[2], forced_code, clean=False)
    check_ring(d, wbs_b)

    # Prepare 1 replays per batch: plain falls back limit_only, the
    # router escalates to the fixpoint tier on the device, and the
    # replay's block shows the rounds it took.
    evs, t = wB[1], tB[1]
    live_before = dict(live)
    created = commit_oracle(evs, t)
    assert len(created) == len(evs) - 1, "the poison event must fail"
    exp = _expected_words(evs, live_before, n_pad_b, n_shards, created)
    pe = pad_transfer_events(transfers_to_arrays(evs), n_pad_b)
    ring_before = np.asarray(d["ring_occupancy"])[:, 0]
    st, out1, fell_back = rt.step(st, pe, t, len(evs))
    assert not fell_back, rt.stats()
    assert rt.escalations >= 1, rt.stats()
    tel1 = _np(out1["shard_stats"]["tel"])
    blocks.append(tel1.tolist())
    d1 = decode_telemetry(tel1)
    assert int(d1["fix_rounds"].max()) >= 1, \
        "the escalated replay must report its fixpoint rounds"
    assert int(d1["poison_cause"].max()) == 0, d1["poison_cause"]
    assert int(d1["cross_shard_transfers"].max()) == \
        exp["cross_shard_transfers"]
    for s in range(n_shards):
        assert int(d1["writeback_transfers"][s]) == \
            exp["writeback_transfers"][s], s
        assert int(d1["ring_occupancy"][s]) == \
            int(ring_before[s]) + exp["writeback_transfers"][s], s
    return dict(blocks=blocks, fix_rounds=int(d1["fix_rounds"].max()))


def _census_check(device, committed: dict) -> dict:
    """Leg 2: the chain call's telemetry census against the committed
    section."""
    from ..ops.batch import transfers_to_arrays
    from ..ops.ledger import _pad_bucket
    from ..parallel.partitioned import stack_partitioned_window
    from ..torchhound import core

    rng = np.random.default_rng(SEED)
    _, rt, st = _new_ledger(8, device)
    wb_ = _WindowBuilder(rng, 8)
    w, tss = zip(*[wb_.prepare() for _ in range(2)])
    arrays = [transfers_to_arrays(e) for e in w]
    ev_p, ts_p, n_p = stack_partitioned_window(arrays, list(tss),
                                               _pad_bucket(8))
    census = core.telemetry_census(core.trace(
        rt._chain_step("plain"), st, ev_p, ts_p, n_p))
    assert census["sites"] >= 1, \
        "the telemetry pack is missing from the chain (a dead plane)"
    assert census["lanes"] == committed["lanes"], (census, committed)
    assert census["ops"] <= committed["pack_ops"], (census, committed)
    return census


def _negative_check(device, real: dict, committed_budget: dict) -> list:
    """Leg 3: a pack grown by one word must red check_telemetry through
    the same census; the real census must pass it. Returns the reds."""
    import torch

    from ..parallel.partitioned import TEL_WORDS, _telemetry_pack
    from ..torchhound import core, opbudget

    words = [torch.full((), i, dtype=torch.int64, device=device)
             for i in range(TEL_WORDS + 1)]
    gc = core.telemetry_census(core.trace(
        lambda: _telemetry_pack(*words, device=device)))
    assert gc["lanes"] == TEL_WORDS + 1, gc
    reds = opbudget.check_telemetry(
        {"lanes": gc["lanes"], "pack_sites": gc["sites"],
         "pack_ops": gc["ops"], "chain_body_heavy_delta": 0},
        committed_budget)
    assert reds and any("lanes" in r for r in reds), \
        f"an over-budget telemetry lane must red the gate: {reds}"
    clean = opbudget.check_telemetry(
        {"lanes": real["lanes"], "pack_sites": real["sites"],
         "pack_ops": real["ops"], "chain_body_heavy_delta": 0},
        committed_budget)
    assert clean == [], clean
    return reds


# On/off pairs the overhead leg times: on the card, where a window's wall
# time moves ~15% from one call to the next, the median of many pairs'
# ratios; off it (measured, not asserted) a few.
OVERHEAD_PAIRS = 16
OVERHEAD_PAIRS_UNTIMED = 4


def _overhead_check(device, ratio_max: float, pairs: int = OVERHEAD_PAIRS,
                    timing: bool = True) -> dict:
    """Leg 4: the chain call's wall time with telemetry on against off,
    the same window against two states, in pairs (one warm pair first,
    the order flipped every pair, no collector pause inside the clock);
    the median of the pairs' on/off ratios."""
    import gc

    import torch

    from ..ops.batch import transfers_to_arrays
    from ..ops.ledger import _pad_bucket
    from ..parallel.partitioned import (
        make_partitioned_chain_create_transfers, stack_partitioned_window)

    rng = np.random.default_rng(SEED + 1)
    orc, rt, st = _new_ledger(8, device)
    steps = {on: make_partitioned_chain_create_transfers(rt.mesh,
                                                         telemetry=on)
             for on in (True, False)}
    states = {True: st, False: rt.from_oracle(orc)}
    wb_ = _WindowBuilder(rng, 8)
    W, NB = 4, 8
    n_pad = _pad_bucket(NB)
    cuda = torch.device(device).type == "cuda"
    times = {True: [], False: []}
    for r in range(pairs + 1):
        w, tss = zip(*[wb_.prepare(NB) for _ in range(W)])
        ev_p, ts_p, n_p = stack_partitioned_window(
            [transfers_to_arrays(e) for e in w], list(tss), n_pad)
        gc.collect()
        gc.disable()
        try:
            for on in ((True, False) if r % 2 else (False, True)):
                if cuda:
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                states[on], out = steps[on](states[on], ev_p, ts_p, n_p,
                                            None)
                if cuda:
                    torch.cuda.synchronize(device)
                if r:
                    times[on].append(time.perf_counter() - t0)
        finally:
            gc.enable()
    ratio = float(np.median([a / b for a, b in zip(times[True],
                                                   times[False])]))
    if timing:
        assert ratio <= ratio_max, (
            f"telemetry overhead ratio {ratio:.4f} > {ratio_max} (median "
            f"of {pairs} pairs; on {np.median(times[True]) * 1e3:.2f} ms, "
            f"off {np.median(times[False]) * 1e3:.2f} ms a window)")
    return dict(ratio=ratio, ratio_max=ratio_max, pairs=pairs,
                on_ms=float(np.median(times[True])) * 1e3,
                off_ms=float(np.median(times[False])) * 1e3)


def telemetry_smoke(device=None) -> dict:
    """The four legs on `device` (None: the card; there the overhead
    ratio must lie within its bound). Returns each mesh's harvested
    blocks, the census, the negative's reds and the overhead."""
    from ..ops.device import resolve_device
    from ..torchhound.core import newest_budget_path

    device = resolve_device(device)
    timing = device.type == "cuda"
    with open(newest_budget_path()) as f:
        committed = json.load(f)
    out = {"decode": {n: _oracle_check(n, device) for n in SHARDS}}
    out["census"] = _census_check(device, committed["telemetry"])
    out["negative_reds"] = _negative_check(device, out["census"], committed)
    out["overhead"] = _overhead_check(
        device, committed["telemetry"]["overhead_ratio_max"],
        OVERHEAD_PAIRS if timing else OVERHEAD_PAIRS_UNTIMED, timing)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    out = telemetry_smoke(args.device)
    print(f"[telemetry-smoke] ok: bit-exact decode on meshes "
          f"{sorted(out['decode'])}, lane census {out['census']} == "
          f"committed, the grown pack reds, overhead ratio "
          f"{out['overhead']['ratio']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
