"""Partitioned-chain smoke: the gate's quick differential for the
partitioned window route.

The port's counterpart of the JAX package's
`testing/partitioned_chain_smoke.py`. Drives
PartitionedRouter.step_window — one chain call a window over the
account-hash-partitioned state — on meshes of 1 and 8 logical shards of
one device (as the JAX gate's 1- and 8-device meshes) and asserts the
serving contract:

  1. eligible windows take the PARTITIONED CHAIN route by default
     (route counters; flagged windows pre-route per batch);
  2. results are bit-exact against the per-batch partitioned ladder AND
     the pure-Python oracle, a window poisoned mid-stream by a limit
     cascade included: the clean prefix stays committed, prepare k
     replays per batch with the plain -> fixpoint escalation on the
     device, the suffix re-windows;
  3. zero HOST fallbacks on both routes, cross-shard transfers on a mesh
     of several shards, and both routes' partitioned digests equal to
     the oracle's;
  4. the committed op budget carries the partitioned chain tiers, and
     the chain body costs the per-batch partitioned tier's heavy ops
     but its harvest (below).

The per-batch step gathers its shard stats (events routed a shard and
the telemetry block) to the first device at every call; the chain
gathers them once a window. So the body's collectives are the per-batch
tier's less HARVEST_GATHERS, and every other class is equal.

``partitioned_chain_smoke(device=None)``;
``python -m tigerbeetle_tpu_torch.testing.partitioned_chain_smoke``.
"""

from __future__ import annotations

import json

import numpy as np

SEED = 37
A_CAP, T_CAP = 1 << 9, 1 << 11
N_ACCTS = 40
SHARDS = (1, 8)   # the JAX gate's meshes of 1 and 8 devices
HARVEST_GATHERS = 2   # the per-batch step's events_owned and telemetry


def _routers(n_shards, device):
    from ..oracle import StateMachineOracle
    from ..parallel.partitioned import PartitionedRouter
    from ..parallel.shard_utils import Mesh
    from ..types import Account, AccountFlags

    mesh = Mesh([device] * n_shards)
    accts = [Account(id=i, ledger=1, code=1,
                     flags=(int(AccountFlags.debits_must_not_exceed_credits)
                            if i <= 4 else 0))
             for i in range(1, N_ACCTS + 1)]
    oracles, routers, states = [], [], []
    for _ in range(2):
        orc = StateMachineOracle()
        orc.create_accounts(accts, 50)
        r = PartitionedRouter(mesh, a_cap=A_CAP, t_cap=T_CAP)
        oracles.append(orc)
        routers.append(r)
        states.append(r.from_oracle(orc))
    return oracles, routers, states


def _windows(rng, n_shards):
    """Three windows: a clean two-phase one (pendings, plain, their
    posts and voids), one poisoned at prepare 1 by a limit cascade, and a
    flagged (balancing) one that pre-routes per batch. Every pair's
    accounts lie on two shards when there are several."""
    from ..parallel.shard_utils import shard_of_int
    from ..types import Transfer, TransferFlags as TF

    def pairs(count):
        out, ids = [], list(range(1, N_ACCTS + 1))
        while len(out) < count:
            dr, cr = rng.choice(ids, 2, replace=False)
            if n_shards == 1 or shard_of_int(int(dr), n_shards) != \
                    shard_of_int(int(cr), n_shards):
                out.append((int(dr), int(cr)))
        return out

    nid, ts = [10 ** 6], [10 ** 9]
    windows = []

    def prepare(n=8, poison=False, flags=0):
        evs = [Transfer(id=nid[0] + i, debit_account_id=dr,
                        credit_account_id=cr,
                        amount=int(rng.integers(1, 30)), ledger=1,
                        code=1, flags=flags)
               for i, (dr, cr) in enumerate(pairs(n))]
        nid[0] += n
        if poison:
            # A debit off a debit-limited account beyond its credits: the
            # plain headroom proof falls back limit_only.
            evs.append(Transfer(id=nid[0], debit_account_id=1,
                                credit_account_id=9, amount=10 ** 6,
                                ledger=1, code=1))
            nid[0] += 1
        ts[0] += 300
        return evs, ts[0]

    p0, t0 = prepare(flags=int(TF.pending))
    p1, t1 = prepare()
    closes = [Transfer(id=nid[0] + i, pending_id=p.id,
                       amount=((1 << 128) - 1) if i % 2 == 0 else 0,
                       flags=int(TF.post_pending_transfer if i % 2 == 0
                                 else TF.void_pending_transfer))
              for i, p in enumerate(p0)]
    nid[0] += len(closes)
    ts[0] += 300
    windows.append(([p0, p1, closes], [t0, t1, ts[0]]))
    w, tss = [], []
    for b in range(3):
        evs, t = prepare(poison=(b == 1))
        w.append(evs)
        tss.append(t)
    windows.append((w, tss))
    evs, t = prepare()
    bal, t2 = prepare(n=2, flags=int(TF.balancing_debit))
    windows.append(([evs, bal], [t, t2]))
    return windows


def _one_mesh(n_shards, device) -> dict:
    from ..ops.batch import transfers_to_arrays
    from ..ops.ledger import _pad_bucket
    from ..ops.state_epoch import (partitioned_oracle_digest,
                                   partitioned_state_digest)

    rng = np.random.default_rng(SEED)
    (orc_c, orc_b), (rt_c, rt_b), (st_c, st_b) = _routers(n_shards, device)
    history = []
    for w, tss in _windows(rng, n_shards):
        arrays = [transfers_to_arrays(e) for e in w]
        st_c, res_c = rt_c.step_window(st_c, arrays, tss)
        st_b, res_b = rt_b._window_per_batch(
            st_b, arrays, tss, _pad_bucket(max(len(e) for e in w)))
        assert len(res_c) == len(res_b) == len(w)
        for evs, t, (stc, rtsc), (stb, rtsb) in zip(w, tss, res_c, res_b):
            want = orc_c.create_transfers(evs, t)
            orc_b.create_transfers(evs, t)
            exp = [(r.timestamp, int(r.status)) for r in want]
            got_c = [(int(rtsc[i]), int(stc[i])) for i in range(len(evs))]
            got_b = [(int(rtsb[i]), int(stb[i])) for i in range(len(evs))]
            assert got_c == exp, (got_c[:4], exp[:4])
            assert got_b == exp, (got_b[:4], exp[:4])
            history.append(got_c)
    wr = rt_c.window_routes
    assert wr.get("partitioned_chain", 0) >= 2, wr
    assert wr.get("partitioned_per_batch", 0) >= 1, wr
    assert rt_c.chain_batch_fallbacks.get("e3_limit", 0) >= 1, \
        rt_c.chain_batch_fallbacks
    assert rt_c.escalations >= 1, rt_c.stats()
    assert rt_c.host_fallbacks == 0, rt_c.stats()
    assert rt_b.host_fallbacks == 0, rt_b.stats()
    if n_shards > 1:
        assert rt_c.cross_shard_transfers > 0, rt_c.stats()
    dd = partitioned_state_digest(st_c)
    assert dd == partitioned_state_digest(st_b)
    assert dd == partitioned_oracle_digest(orc_c, A_CAP, n_shards), dd
    return dict(history=history, digest=dd,
                routes=dict(wr),
                chain_batch_fallbacks=dict(rt_c.chain_batch_fallbacks),
                escalations=rt_c.escalations,
                host_fallbacks=(rt_c.host_fallbacks, rt_b.host_fallbacks),
                cross_shard_transfers=rt_c.cross_shard_transfers)


def check_budget(budget: dict) -> None:
    """The partitioned chain tiers are pinned, and the body costs the
    per-batch partitioned tier less its harvest gathers."""
    for tier in ("partitioned_chain_w2", "partitioned_chain_w8",
                 "partitioned_chain_w32", "partitioned_chain_body"):
        assert tier in budget, f"the op budget lacks {tier}"
    body, plain = (budget["partitioned_chain_body"],
                   budget["partitioned_plain"])
    want = dict(plain["heavy"],
                collective=plain["heavy"]["collective"] - HARVEST_GATHERS)
    assert body["heavy"] == want, (body["heavy"], plain["heavy"])
    assert body["heavy_total"] == plain["heavy_total"] - HARVEST_GATHERS, \
        "the chain body must cost the per-batch partitioned tier"


def partitioned_chain_smoke(device=None) -> dict:
    """Each mesh of SHARDS logical shards of `device` (None: the card). Returns {n_shards: {history, digest, routes, ...}} and the
    budget's body and per-batch heavy totals; raises on any failure."""
    from ..ops.device import resolve_device
    from ..torchhound.core import newest_budget_path

    device = resolve_device(device)
    out = {n: _one_mesh(n, device) for n in SHARDS}
    with open(newest_budget_path()) as f:
        budget = json.load(f)["budget"]
    check_budget(budget)
    out["budget"] = {t: budget[t]["heavy_total"] for t in (
        "partitioned_chain_body", "partitioned_plain")}
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    out = partitioned_chain_smoke(args.device)
    print("[partitioned-chain-smoke] ok: chain default route on 1 and 8 "
          "shards, per-prepare fallback, per-batch and oracle parity, "
          f"digests equal, budgets {out['budget']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
