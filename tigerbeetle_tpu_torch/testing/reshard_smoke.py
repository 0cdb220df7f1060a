"""Reshard smoke: the gate's live-resharding leg.

The port's counterpart of the JAX package's `testing/reshard_smoke.py`.
Drives the elastic-shard protocol (`parallel/resharding.py`) against the
partitioned window route under live traffic, on meshes of 2 and 8
logical shards of one device, and asserts the crash-safety contract end
to end:

  1. a detector-style SPLIT (half of shard 0's hash space), a plain
     MIGRATE of a second range and a MERGE_BACK of the split all
     complete while seeded transfer windows keep committing: the copy
     streams in bounded chunks between windows, and every flip passes
     the source == target range-digest witness (zero aborts);
  2. the history is BIT-EXACT against the never-resharded oracle, and the
     final partitioned digest equals the oracle's placed by the overlay
     left after the migrations; the state's storage never moves;
  3. zero host fallbacks;
  4. the NEGATIVE: a corrupted copy chunk aborts BEFORE the flip
     (digest-mismatch witness), reverts the overlay and leaves a
     FLIGHT_*_reshard_* artifact in the flight directory the caller
     gives; a flip that goes through is red, and traffic after the abort
     stays exact.

`ReshardRun` holds one mesh's run (oracle, router, state, controller,
traffic); `mesh_run` and `negative_run` drive it. A caller that steps a
twin beside the port (the tests step the JAX package's controller in
lockstep) subclasses it and extends `begin`, `corrupt_next_chunk`,
`step`, `range_digest` and `final`.

``reshard_smoke(device=None, flight_dir=None)``;
``python -m tigerbeetle_tpu_torch.testing.reshard_smoke``.
"""

from __future__ import annotations

import glob
import os
import tempfile

import numpy as np

SEED = 23
A_CAP, T_CAP = 1 << 9, 1 << 11
N_ACCTS = 40
_HALF = 1 << 63
_U64MAX = (1 << 64) - 1


def _window(rng, nid, ts, n_batches=2, n=8):
    """One window: n_batches prepares of n transfers between two distinct
    random accounts (port Transfer objects) and their timestamps."""
    from ..types import Transfer

    batches, tss = [], []
    for _ in range(n_batches):
        evs = []
        for _i in range(n):
            dr, cr = rng.choice(np.arange(1, N_ACCTS + 1), 2, replace=False)
            evs.append(Transfer(id=nid[0], debit_account_id=int(dr),
                                credit_account_id=int(cr),
                                amount=int(rng.integers(1, 30)),
                                ledger=1, code=1))
            nid[0] += 1
        ts[0] += 300
        batches.append(evs)
        tss.append(ts[0])
    return batches, tss


def plans(n_shards: int) -> list:
    """The positive arm's three moves on a mesh of n_shards."""
    from ..parallel.resharding import ReshardPlan

    return [ReshardPlan(lo=0, hi=_HALF - 1, src=0, dst=1, kind="split"),
            ReshardPlan(lo=_HALF, hi=_U64MAX, src=1,
                        dst=(n_shards - 1 if n_shards > 2 else 0),
                        kind="migrate"),
            ReshardPlan(lo=0, hi=_HALF - 1, src=0, dst=1,
                        kind="merge_back")]


class ReshardRun:
    """One mesh's run: an oracle with accounts 1..40, a router on
    n_shards logical shards of `device` (its flight recorder dumping into
    flight_dir), its state, a controller (chunks of chunk_rows, two
    double-write windows at least) and the traffic's generator."""

    def __init__(self, n_shards: int, device, seed: int, flight_dir=None,
                 chunk_rows: int = 8):
        from ..oracle import StateMachineOracle
        from ..ops.window_graph import state_signature
        from ..parallel.partitioned import PartitionedRouter
        from ..parallel.resharding import ReshardController
        from ..parallel.shard_utils import Mesh
        from ..trace import FlightRecorder
        from ..types import Account

        self.n = n_shards
        self.orc = StateMachineOracle()
        self.orc.create_accounts([Account(id=i, ledger=1, code=1)
                                  for i in range(1, N_ACCTS + 1)], 50)
        self.router = PartitionedRouter(
            Mesh([device] * n_shards), a_cap=A_CAP, t_cap=T_CAP,
            flight_recorder=FlightRecorder(dump_dir=flight_dir))
        self.state = self.router.from_oracle(self.orc)
        self.sig = state_signature(self.state)
        self.ctl = ReshardController(self.router, chunk_rows=chunk_rows,
                                     min_double_write_windows=2)
        self.rng = np.random.default_rng(seed)
        self.nid, self.ts = [10 ** 6], [10 ** 9]
        self.history: list = []
        self.digests: list = []

    def begin(self, plan) -> None:
        self.state = self.ctl.begin(self.state, plan)

    def corrupt_next_chunk(self) -> None:
        """Corrupt the next copy chunk (the negative arm)."""
        self.ctl.corrupt_next_chunk = True

    def window(self):
        """One window of traffic; returns the abort's reason (None: none)."""
        return self.step(*_window(self.rng, self.nid, self.ts))

    def step(self, batches, tss):
        """The controller's tick, then the window through the chain route;
        each prepare's results must equal the oracle's. Returns the abort's
        reason, or None."""
        from ..ops.batch import transfers_to_arrays
        from ..parallel.resharding import MigrationAborted

        arrays = [transfers_to_arrays(e) for e in batches]
        aborted = None
        try:
            self.state = self.ctl.on_window(self.state, arrays)
        except MigrationAborted as e:
            self.state, aborted = e.state, e.reason
        self.state, results = self.router.step_window(self.state, arrays,
                                                      tss)
        for evs, t, (st, rts) in zip(batches, tss, results):
            want = [(r.timestamp, int(r.status))
                    for r in self.orc.create_transfers(evs, t)]
            got = [(int(rts[i]), int(st[i])) for i in range(len(evs))]
            assert got == want, (got[:4], want[:4])
            self.history.append(got)
        self.results = results
        return aborted

    def range_digest(self, plan) -> dict:
        """The moved range's digest on its source after a migration."""
        from ..ops.state_epoch import partitioned_range_digest

        d = partitioned_range_digest(self.state, plan.lo, plan.hi, plan.src)
        self.digests.append(d)
        return d

    def final(self) -> dict:
        """Zero host fallbacks, the state's storage unmoved, the digest
        equal to the oracle's under the overlay; returns the digest."""
        from ..ops.state_epoch import (partitioned_oracle_digest,
                                       partitioned_state_digest)
        from ..ops.window_graph import state_signature

        assert self.router.host_fallbacks == 0, self.router.stats()
        assert state_signature(self.state) == self.sig, \
            "a migration moved the state's storage"
        dd = partitioned_state_digest(self.state)
        want = partitioned_oracle_digest(
            self.orc, A_CAP, self.n, overlay=self.router.ownership.entries)
        assert dd == want, (dd, want)
        return dd


def mesh_run(run: ReshardRun) -> dict:
    """The positive arm: two warm windows, the split, the migrate and the
    merge_back (a window a tick until each is done), two windows more."""
    from ..parallel.shard_utils import OVERLAY_MIGRATED

    for _ in range(2):
        assert run.window() is None
    for plan in plans(run.n):
        run.begin(plan)
        guard = 0
        while run.ctl.stage != "done":
            assert run.window() is None
            guard += 1
            assert guard < 64, (plan, run.ctl.stage)
        assert not run.ctl.aborts, run.ctl.aborts
        run.range_digest(plan)
    for _ in range(2):
        assert run.window() is None
    assert len(run.ctl.migrations) == 3, run.ctl.migrations
    for m in run.ctl.migrations:
        assert m["rows_copied"] > 0 and m["double_write_windows"] >= 2, m
    # The split and the migrate leave their MIGRATED overrides; the
    # merge_back dropped its own.
    entries = run.router.ownership.entries
    assert len(entries) == 1 and entries[0][4] == OVERLAY_MIGRATED, entries
    digest = run.final()
    return dict(shards=run.n, history=run.history, digest=digest,
                range_digests=run.digests,
                migrations=[{k: v for k, v in m.items()
                             if k != "duration_s"}
                            for m in run.ctl.migrations],
                windows=len(run.history), entries=entries)


def negative_run(run: ReshardRun, flight_dir: str) -> dict:
    """The negative arm: a corrupted chunk must abort before the flip,
    revert the overlay and leave a reshard flight artifact in flight_dir
    (the router's dump directory); traffic after it stays exact."""
    from ..parallel.resharding import ReshardPlan

    for _ in range(2):
        assert run.window() is None
    run.begin(ReshardPlan(lo=0, hi=_HALF - 1, src=0, dst=1))
    run.corrupt_next_chunk()
    aborted, guard = None, 0
    while aborted is None:
        aborted = run.window()
        guard += 1
        assert guard < 64, "the corrupted migration never aborted"
        if run.ctl.stage == "done":
            raise AssertionError("red: a flip went through on a corrupted "
                                 "copy")
    assert aborted == "digest_mismatch", aborted
    assert run.ctl.stage == "aborted", run.ctl.stage
    assert run.router.ownership.entries == (), run.router.ownership.entries
    arts = glob.glob(os.path.join(flight_dir, "FLIGHT_*_reshard_*"))
    assert arts, f"no reshard flight artifact in {flight_dir}"
    for _ in range(2):
        assert run.window() is None
    digest = run.final()
    return dict(shards=run.n, abort=aborted, artifacts=len(arts),
                history=run.history, digest=digest,
                aborts=[dict(a) for a in run.ctl.aborts])


def reshard_smoke(device=None, flight_dir: str | None = None) -> dict:
    """The positive arm on meshes of 2 and 8 logical shards and the
    negative on 2, on `device` (None: the card); the negative's flight
    artifacts go to flight_dir (None: a temporary directory). Returns each arm's
    summary; raises on any failure."""
    from ..ops.device import resolve_device

    device = resolve_device(device)
    out = {}
    with tempfile.TemporaryDirectory(prefix="tb_reshard_") as tmp:
        for n in (2, 8):
            out[n] = mesh_run(ReshardRun(n, device, SEED + n,
                                         os.path.join(tmp, f"mesh{n}")))
        fd = flight_dir or os.path.join(tmp, "negative")
        os.makedirs(fd, exist_ok=True)
        out["negative"] = negative_run(
            ReshardRun(2, device, SEED + 100 + 2, fd), fd)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--flight-dir", default=None)
    args = ap.parse_args(argv)
    out = reshard_smoke(args.device, args.flight_dir)
    print(f"[reshard-smoke] ok: split+migrate+merge_back live on 2 shards "
          f"({out[2]['windows']} batches) and 8 ({out[8]['windows']}), "
          f"digest witness at every flip, zero aborts and host fallbacks, "
          f"history bit-exact; the negative aborted before the flip "
          f"({out['negative']['abort']}) with "
          f"{out['negative']['artifacts']} flight artifact(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
