"""Overlap smoke: the gate's proof that double-buffered window staging
overlaps host pack and copy work with the device's — and that the proof
can fail.

The port's counterpart of the JAX package's `testing/overlap_smoke.py`.
Drives the pipelined serving loop (ServingSupervisor.
submit_transfers_window: stage k -> resolve the oldest at depth ->
dispatch k) on a seeded workload and asserts:

  1. OVERLAP IS REAL: every eligible window's operand pack is staged
     ahead on the stager thread (staged == windows but at most one
     designed discard, zero identity misses but that one), and the
     measured host_stall_fraction — the share of the staging work the
     dispatch path waited on — lies strictly under STALL_CEILING;
  2. THE NEGATIVE REDS: the same run with staging forced synchronous
     (DeviceLedger.overlap_staging = False) measures a
     host_stall_fraction of exactly 1.0, which fails the predicate;
  3. BIT-EXACT: both arms' histories are equal, entry for entry, a
     window poisoned mid-stream by a limit cascade included, equal to
     an oracle replay of the same windows, and the epoch verify (oracle
     replay, digest, mirror audit) passes with no recovery;
  4. the same on the PARTITIONED CHAIN route (attach mode, the ledger's
     own pipeline, on a mesh of logical shards): staged dispatches, the
     overlapped fraction below the sync arm's 1.0, partitioned digests
     equal to the oracle's.

The stall fraction is a clock reading: `overlap_smoke` asserts the
ceiling on the card only; the forced-sync arm's 1.0 holds everywhere.

``overlap_smoke(device=None)``;
``python -m tigerbeetle_tpu_torch.testing.overlap_smoke [--device cpu]``.
"""

from __future__ import annotations

import numpy as np

SEED = 61
A_CAP, T_CAP = 1 << 10, 1 << 13
N_ACCOUNTS = 200
WINDOWS = 10         # pipelined windows an arm
DEPTH = 4            # prepares a window
BATCH = 128          # transfers a prepare
POISON_WINDOW = 3
PART_SHARDS = 8

# The overlapped run's host_stall_fraction ceiling (the JAX package's):
# above the measured band, strictly below the forced-sync arm's 1.0.
STALL_CEILING = 0.75


def _mk_windows(rng, windows: int = WINDOWS, depth: int = DEPTH,
                batch: int = BATCH, poison_window: int = POISON_WINDOW):
    """Seeded plain-transfer windows (chain eligible), one poisoned
    mid-stream: a debit off a debit-limited account beyond its credits,
    whose headroom proof falls back limit_only. Prepares commit 500 ns
    apart (the JAX leg's spacing) or, for prepares of more events, their
    size plus 10, so no two events share a timestamp."""
    from ..types import Transfer

    nid, ts = 10 ** 6, 10 ** 9
    out = []
    for w in range(windows):
        batches, tss = [], []
        for b in range(depth):
            n = batch
            dr = rng.integers(5, N_ACCOUNTS + 1, n)
            cr = rng.integers(5, N_ACCOUNTS + 1, n)
            clash = dr == cr
            cr[clash] = dr[clash] % N_ACCOUNTS + 5
            evs = [Transfer(id=nid + i, debit_account_id=int(dr[i]),
                            credit_account_id=int(cr[i]),
                            amount=int(rng.integers(1, 50)), ledger=1,
                            code=1)
                   for i in range(n)]
            nid += n
            if w == poison_window and b == 1:
                evs.append(Transfer(id=nid, debit_account_id=1,
                                    credit_account_id=9, amount=10 ** 9,
                                    ledger=1, code=1))
                nid += 1
            ts += max(500, batch + 10)
            batches.append(evs)
            tss.append(ts)
        out.append((batches, tss))
    return out


def _accounts():
    from ..types import Account, AccountFlags

    dr_limit = int(AccountFlags.debits_must_not_exceed_credits)
    return [Account(id=i, ledger=1, code=1,
                    flags=(dr_limit if i <= 4 else 0))
            for i in range(1, N_ACCOUNTS + 1)]


def _run_serving(windows, overlap, device, caps):
    """One pipelined supervisor arm over the windows: (history, staging
    summary, fallbacks, the last history entries)."""
    from ..serving import ServingSupervisor

    sup = ServingSupervisor(caps[0], caps[1],
                            epoch_interval=10 * len(windows), device=device)
    sup.led.overlap_staging = overlap
    sup.create_accounts(_accounts(), N_ACCOUNTS + 10)
    for batches, tss in windows:
        sup.submit_transfers_window(batches, tss)
    sup.drain_pipeline()
    assert sup.verify_epoch(), f"epoch verify failed: {sup.last_recovery}"
    assert sup.last_recovery is None, sup.last_recovery
    sm = sup.led.staging_summary()
    fallbacks = sup.led.fallbacks
    routes = sup.led.fallback_stats()["routes"]
    sup.led.shutdown_staging()
    history = list(sup.history)
    sup.led.release()
    return history, sm, fallbacks, routes


def _replay(orc, windows):
    for batches, tss in windows:
        for evs, t in zip(batches, tss):
            orc.create_transfers(evs, t)
    return orc


def _oracle_history(windows) -> list:
    """The supervisor's history entries for the windows, from an oracle
    replay: one list of (timestamp, status) pairs a prepare, a window
    an entry."""
    from ..oracle import StateMachineOracle

    orc = StateMachineOracle()
    orc.create_accounts(_accounts(), N_ACCOUNTS + 10)
    out = []
    for batches, tss in windows:
        out.append([[(r.timestamp, int(r.status))
                     for r in orc.create_transfers(evs, t)]
                    for evs, t in zip(batches, tss)])
    return out


def _partitioned_windows(rng) -> list:
    """The partitioned arm's 4 windows of 3 prepares of 8 transfers over
    accounts 1..40."""
    from ..types import Transfer

    nid, ts = 10 ** 6, 10 ** 9
    windows = []
    for _ in range(4):
        batches, tss = [], []
        for _b in range(3):
            n = 8
            dr = rng.integers(1, 41, n)
            cr = rng.integers(1, 41, n)
            clash = dr == cr
            cr[clash] = dr[clash] % 40 + 1
            batches.append(
                [Transfer(id=nid + i, debit_account_id=int(dr[i]),
                          credit_account_id=int(cr[i]),
                          amount=int(rng.integers(1, 30)), ledger=1,
                          code=1) for i in range(n)])
            nid += n
            ts += 300
            tss.append(ts)
        windows.append((batches, tss))
    return windows


def _partitioned_arm(device, n_shards: int = PART_SHARDS) -> dict:
    """The ledger's own pipeline on the partitioned chain (attach mode),
    overlapped against forced-sync, against the oracle's digest."""
    from ..oracle import StateMachineOracle
    from ..ops.batch import transfers_to_arrays
    from ..ops.ledger import DeviceLedger
    from ..ops.state_epoch import (partitioned_oracle_digest,
                                   partitioned_state_digest)
    from ..parallel.partitioned import PartitionedRouter
    from ..parallel.shard_utils import Mesh
    from ..types import Account

    windows = _partitioned_windows(np.random.default_rng(SEED + 1))
    accts = [Account(id=i, ledger=1, code=1) for i in range(1, 41)]
    digests, fractions, results, summaries = [], [], [], []
    orc = None
    for overlap in (True, False):
        orc = StateMachineOracle()
        orc.create_accounts(accts, 50)
        router = PartitionedRouter(Mesh([device] * n_shards), a_cap=A_CAP,
                                   t_cap=T_CAP)
        led = DeviceLedger(A_CAP, T_CAP, device=device)
        led.attach_partitioned(router, router.from_oracle(orc))
        led.overlap_staging = overlap
        tickets = []
        for batches, tss in windows:
            evs = [transfers_to_arrays(b) for b in batches]
            led.stage_window(evs, tss)
            if len(led._tickets) >= 2:
                led.resolve_windows(count=1)
            tk = led.submit_window(evs, tss)
            assert tk is not None, "a window fell off the partitioned chain"
            tickets.append(tk)
        led.resolve_windows()
        norm = []
        for tk in tickets:
            _kind, pairs = tk.results
            norm.append([[(int(t), int(s))
                          for s, t in zip(np.asarray(st).tolist(),
                                          np.asarray(ts_).tolist())]
                         for st, ts_ in pairs])
        results.append(norm)
        sm = led.staging_summary()
        summaries.append(sm)
        fractions.append(sm["host_stall_fraction"])
        if overlap:
            assert sm["staged"] == len(windows), sm
            assert sm["misses"] == 0, sm
        else:
            assert sm["staged"] == 0, sm
            assert sm["host_stall_fraction"] == 1.0, sm
        digests.append(partitioned_state_digest(led.partitioned_state))
        led.shutdown_staging()
    assert results[0] == results[1], "partitioned overlap parity broke"
    assert digests[0] == digests[1], digests
    assert digests[0] == partitioned_oracle_digest(
        _replay(orc, windows), A_CAP, n_shards), \
        "partitioned digest diverged from the oracle"
    assert fractions[0] < fractions[1], fractions
    return dict(shards=n_shards, history=results[0], digest=digests[0],
                fraction=fractions[0], staging=summaries)


def overlap_smoke(device=None, windows: int = WINDOWS, batch: int = BATCH,
                  caps: tuple = (A_CAP, T_CAP), partitioned: bool = True
                  ) -> dict:
    """Both supervisor arms (and, with `partitioned`, the partitioned
    arm) on `device` (None: the card): `windows` windows of DEPTH
    prepares of `batch` transfers at `caps`. On the card the overlapped
    fraction must lie under STALL_CEILING. Returns the histories,
    staging summaries and fractions; raises on any failure."""
    from ..ops.device import resolve_device

    device = resolve_device(device)
    timing = device.type == "cuda"
    rng = np.random.default_rng(SEED)
    wins = _mk_windows(rng, windows, DEPTH, batch)

    # Arm 1, overlapped (the default): every window staged ahead and
    # consumed but at most one designed discard (the poisoned window's
    # redo flips the fixpoint-first routing hysteresis between a later
    # window's stage and its submit; a stage whose route no longer
    # matches is dropped, never trusted).
    hist_ov, sm_ov, fb_ov, routes = _run_serving(wins, True, device, caps)
    assert sm_ov["overlap"] is True, sm_ov
    assert sm_ov["staged"] >= windows - 1, sm_ov
    assert sm_ov["misses"] <= 1, sm_ov
    frac_ov = sm_ov["host_stall_fraction"]
    assert frac_ov is not None, sm_ov
    if timing:
        assert frac_ov < STALL_CEILING, (
            f"host_stall_fraction {frac_ov} breached the ceiling "
            f"{STALL_CEILING}: window staging no longer hides behind the "
            f"device ({sm_ov})")

    # Arm 2, the negative: staging forced synchronous measures exactly
    # 1.0 and fails the predicate.
    hist_sy, sm_sy, fb_sy, _ = _run_serving(wins, False, device, caps)
    assert sm_sy["overlap"] is False and sm_sy["staged"] == 0, sm_sy
    frac_sy = sm_sy["host_stall_fraction"]
    assert frac_sy == 1.0, sm_sy
    assert not (frac_sy < STALL_CEILING), \
        "forced-sync staging passed the overlap ceiling"

    assert hist_ov == hist_sy, "overlap changed results"
    assert fb_ov == fb_sy, (fb_ov, fb_sy)
    oracle = _oracle_history(wins)
    assert hist_ov[-len(wins):] == oracle, "the history diverged from the " \
        "oracle"
    assert any(s != 0 for win in hist_ov[-len(wins):] for pre in win
               for _t, s in pre), "the poisoned window never poisoned"
    out = dict(history=hist_ov[-len(wins):], fraction=frac_ov,
               sync_fraction=frac_sy, staging=sm_ov, sync_staging=sm_sy,
               fallbacks=fb_ov, routes=routes, ceiling=STALL_CEILING)
    if partitioned:
        out["partitioned"] = _partitioned_arm(device)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    out = overlap_smoke(args.device)
    print(f"[overlap-smoke] ok: staged {out['staging']['staged']}/"
          f"{WINDOWS} windows, host_stall_fraction {out['fraction']} "
          f"(sync arm {out['sync_fraction']}, negative reds), history "
          f"parity incl. the poisoned window, partitioned arm fraction "
          f"{out['partitioned']['fraction']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
