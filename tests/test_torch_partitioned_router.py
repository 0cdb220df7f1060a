"""Port parity: the partitioned route's router on the CPU, against the JAX
package's on 8 shards (its 8 host devices) and against the oracle:
`PartitionedRouter.step_window` on the cases of the JAX package's
  tests/test_partitioned.py: a two-phase window whose pendings and their
  posts / voids straddle prepares and shards (one chain call), closing x
  balancing batches across shards, a Zipfian hot account, and a window
  with a balancing flag that pre-routes per batch. Every prepare's
  results, the routers' stats (escalations, fallbacks, causes, routes,
  events a shard, cross-shard transfers, the decoded telemetry) and the
  state digests equal the JAX package's and the oracle's. Exact
comparisons throughout; the JAX steps are compiled once, in
tests/test_torch_partitioned.py's module caches. The attach mode and
the chaos scenario are in tests/test_torch_partitioned_ledger.py.
"""

import numpy as np
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.ops import batch as JB
from tigerbeetle_tpu.ops import state_epoch as JSE
from tigerbeetle_tpu.oracle import StateMachineOracle as JOracle
from tigerbeetle_tpu.parallel.shard_utils import shard_of_int
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.ops import state_epoch as TSE
from tigerbeetle_tpu_torch.oracle.state_machine import \
    StateMachineOracle as TOracle
from tigerbeetle_tpu_torch.parallel import partitioned as TP
from tests.test_torch_partitioned import A_CAP, T_CAP, _jrouter, _tmesh

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

N_DEV = 8
PEND = int(JT.TransferFlags.pending)
POST = int(JT.TransferFlags.post_pending_transfer)
VOID = int(JT.TransferFlags.void_pending_transfer)
BAL_DR = int(JT.TransferFlags.balancing_debit)
CLOSE_DR = int(JT.TransferFlags.closing_debit)
DR_LIMIT = int(JT.AccountFlags.debits_must_not_exceed_credits)
AMOUNT_MAX = (1 << 128) - 1


def _cross_pairs(rng, count, first=1):
    """(dr, cr) account ids first..40 on different shards of the mesh."""
    out, ids = [], list(range(first, 41))
    while len(out) < count:
        dr, cr = rng.choice(ids, 2, replace=False)
        if shard_of_int(int(dr), N_DEV) != shard_of_int(int(cr), N_DEV):
            out.append((int(dr), int(cr)))
    return out


class Pair:
    """The JAX package's router and the port's, each beside its own
    package's oracle, from the same accounts."""

    def __init__(self, limited=()):
        self.oracles, self.states = [], []
        for O, T in ((JOracle, JT), (TOracle, TT)):
            sm = O()
            sm.create_accounts([T.Account(id=i, ledger=1, code=1,
                                          flags=DR_LIMIT if i in limited
                                          else 0)
                                for i in range(1, 41)], 50)
            self.oracles.append(sm)
        self.jr = _jrouter(N_DEV)
        self.tr = TP.PartitionedRouter(_tmesh(N_DEV), a_cap=A_CAP,
                                       t_cap=T_CAP)
        self.js = self.jr.from_oracle(self.oracles[0])
        self.ts = self.tr.from_oracle(self.oracles[1])

    def window(self, make, tss):
        """One window (`make(T)` -> a list of prepares' transfers) through
        both routers' step_window and both oracles."""
        arrays = [JB.transfers_to_arrays(e) for e in make(JT)]
        self.js, j_res = self.jr.step_window(self.js, arrays, tss)
        self.ts, t_res = self.tr.step_window(self.ts, arrays, tss)
        assert len(t_res) == len(j_res) == len(arrays)
        for (js_, jt_), (ts_, tt_) in zip(j_res, t_res):
            np.testing.assert_array_equal(ts_, np.asarray(js_))
            np.testing.assert_array_equal(tt_, np.asarray(jt_))
        for sm, T in zip(self.oracles, (JT, TT)):
            for evs, t, (st, rts) in zip(make(T), tss, t_res):
                want = sm.create_transfers(evs, t)
                assert [(int(a), int(b)) for a, b in zip(rts, st)] == \
                    [(r.timestamp, int(r.status)) for r in want]

    def finish(self):
        assert self.tr.stats() == self.jr.stats()
        assert self.tr.host_fallbacks == 0
        digest = TSE.partitioned_state_digest(self.ts)
        assert digest == JSE.partitioned_state_digest(self.js)
        assert digest == TSE.partitioned_oracle_digest(self.oracles[1],
                                                       A_CAP, N_DEV)


def test_two_phase_window_straddling_prepares_and_shards():
    rng = np.random.default_rng(23)
    pairs = [_cross_pairs(rng, 12) for _ in range(3)]
    p = Pair()

    def make(T):
        nid, out, pendings = 10 ** 6, [], []
        for b in range(3):
            evs = []
            for dr, cr in pairs[b]:
                if b < 2 or not pendings:
                    evs.append(T.Transfer(id=nid, debit_account_id=dr,
                                          credit_account_id=cr,
                                          amount=5 + nid % 7, ledger=1,
                                          code=1, flags=PEND))
                    pendings.append(nid)
                else:
                    pid = pendings.pop(0)
                    f = POST if nid % 2 else VOID
                    evs.append(T.Transfer(id=nid, pending_id=pid,
                                          amount=AMOUNT_MAX if f == POST
                                          else 0, flags=f))
                nid += 1
            out.append(evs)
        return out

    p.window(make, [10 ** 9 + 300 * (b + 1) for b in range(3)])
    assert p.tr.window_routes == {"partitioned_chain": 1}
    assert p.tr.cross_shard_transfers > 0
    p.finish()


def test_closing_balancing_batches_across_shards():
    rng = np.random.default_rng(13)
    pairs = _cross_pairs(rng, 16)
    p = Pair(limited=range(1, 9))
    ts = [10 ** 9]

    def one(make):
        ts[0] += 300
        p.window(lambda T: [make(T)], [ts[0]])

    one(lambda T: [T.Transfer(id=1000 + i, debit_account_id=20 + i % 16,
                              credit_account_id=1 + i % 8, amount=100 + i,
                              ledger=1, code=1) for i in range(16)])
    one(lambda T: [T.Transfer(id=2000 + i, debit_account_id=1 + i % 8,
                              credit_account_id=dr if dr > 8 else cr,
                              amount=AMOUNT_MAX, ledger=1, code=1,
                              flags=BAL_DR)
                   for i, (dr, cr) in enumerate(pairs[:8])])
    dr, cr = pairs[8]
    one(lambda T: [
        T.Transfer(id=3000, debit_account_id=dr, credit_account_id=cr,
                   amount=1, ledger=1, code=1, flags=PEND | CLOSE_DR),
        T.Transfer(id=3001, debit_account_id=dr, credit_account_id=cr,
                   amount=5, ledger=1, code=1),
        T.Transfer(id=3002, debit_account_id=1, credit_account_id=cr,
                   amount=AMOUNT_MAX, ledger=1, code=1, flags=BAL_DR)])
    one(lambda T: [
        T.Transfer(id=3003, pending_id=3000, amount=0, flags=VOID),
        T.Transfer(id=3004, debit_account_id=dr, credit_account_id=cr,
                   amount=2, ledger=1, code=1)])
    assert p.tr.window_routes == {"partitioned_per_batch": 4}
    p.finish()


def test_zipfian_hot_account():
    rng = np.random.default_rng(17)
    draws = [np.minimum(rng.zipf(1.3, size=(150, 2)), 40) for _ in range(3)]
    p = Pair()
    for b, d in enumerate(draws):
        def make(T, d=d, b=b):
            out = []
            for i, (dr, cr) in enumerate(d):
                dr, cr = int(dr), int(cr)
                if dr == cr:
                    cr = dr % 40 + 1
                out.append(T.Transfer(id=10 ** 6 + 150 * b + i,
                                      debit_account_id=dr,
                                      credit_account_id=cr,
                                      amount=1 + i % 39, ledger=1, code=1))
            return [out]
        p.window(make, [10 ** 9 + 300 * (b + 1)])
    owned = p.tr.stats()["events_owned"]
    assert sum(owned) == p.tr.batches * 150
    p.finish()


def test_flagged_window_preroutes_per_batch():
    p = Pair(limited=(1, 2))
    p.window(lambda T: [[T.Transfer(id=100, debit_account_id=10,
                                    credit_account_id=1, amount=50,
                                    ledger=1, code=1)]], [10 ** 9 + 300])
    p.window(lambda T: [
        [T.Transfer(id=101, debit_account_id=1, credit_account_id=11,
                    amount=AMOUNT_MAX, ledger=1, code=1, flags=BAL_DR)],
        [T.Transfer(id=102, debit_account_id=12, credit_account_id=13,
                    amount=3, ledger=1, code=1)]],
        [10 ** 9 + 600, 10 ** 9 + 900])
    assert p.tr.window_routes.get("partitioned_per_batch") == 2
    assert "partitioned_chain" not in p.tr.window_routes
    p.finish()
