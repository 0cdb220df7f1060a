"""Port parity: the partitioned route's consumers on the CPU, against the
JAX package's on 8 shards (its 8 host devices) and against the oracle.

- The attach mode: a `DeviceLedger(device="cpu")` attached to a router,
  windows submitted three deep (the second poisoned by a limit cascade
  at prepare 1, so its prefix stands and the windows after it replay),
  then a synchronous window: results, `fallback_stats()["routes"]` and
  `device_telemetry` equal the JAX ledger's, the digest the oracle's;
  write-through is refused; `DeviceLedger()` with no CUDA device still
  raises.
- `shard_resync_scenario` equal to the JAX package's for two seeds:
  tests/test_torch_chaos.py, beside the default chaos seed that draws the
  mesh scenario (the JAX package's cached router compiled once there).

Exact comparisons throughout. The JAX steps are compiled once, in
tests/test_torch_partitioned.py's module caches.
"""

import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.ops import batch as JB
from tigerbeetle_tpu.ops import ledger as JL
from tigerbeetle_tpu.ops import state_epoch as JSE
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.ops import ledger as TL
from tigerbeetle_tpu_torch.ops import state_epoch as TSE
from tigerbeetle_tpu_torch.oracle.state_machine import \
    StateMachineOracle as TOracle
from tigerbeetle_tpu_torch.parallel import partitioned as TP
from tigerbeetle_tpu_torch.parallel.shard_utils import default_mesh
from tests.test_torch_partitioned import A_CAP, T_CAP, _tmesh
from tests.test_torch_partitioned_router import N_DEV, Pair, _cross_pairs

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)


# ------------------------------------------------------------ attach mode

def _attach_windows(T):
    """Three windows of 3 prepares; the second debits a limited account
    past its funding at prepare 1 (a limit cascade), so its prefix [0, 1)
    stands, prepare 1 replays per batch (escalating on the device), and
    the windows after it, in flight and poisoned, replay."""
    rng = np.random.default_rng(31)
    nid, ts = 10 ** 6, 10 ** 9
    out = []
    for w in range(3):
        evs, tss = [], []
        for b in range(3):
            e = [T.Transfer(id=nid + i, debit_account_id=dr,
                            credit_account_id=cr, amount=1 + i % 29,
                            ledger=1, code=1)
                 for i, (dr, cr) in enumerate(_cross_pairs(rng, 16, 5))]
            nid += 16
            if w == 1 and b == 1:
                e.append(T.Transfer(id=nid, debit_account_id=1,
                                    credit_account_id=9, amount=10 ** 6,
                                    ledger=1, code=1))
                nid += 1
            ts += 300
            evs.append(e)
            tss.append(ts)
        out.append((evs, tss))
    return out


def test_attach_mode_equals_the_jax_ledgers():
    p = Pair(limited=(1, 2, 3, 4))
    j_led = JL.DeviceLedger(a_cap=A_CAP, t_cap=T_CAP)
    j_led.attach_partitioned(p.jr, p.js)
    t_led = TL.DeviceLedger(A_CAP, T_CAP, device="cpu")
    t_led.attach_partitioned(p.tr, p.ts)
    wins = {k: _attach_windows(T) for k, T in (("j", JT), ("t", TT))}
    tickets = {"j": [], "t": []}
    for (j_evs, tss), _ in zip(wins["j"], wins["t"]):
        arrays = [JB.transfers_to_arrays(e) for e in j_evs]
        for key, led in (("j", j_led), ("t", t_led)):
            tk = led.submit_window(arrays, tss)
            assert tk is not None
            tickets[key].append(tk)
    j_led.resolve_windows()
    t_led.resolve_windows()
    for jt, tt in zip(tickets["j"], tickets["t"]):
        assert jt.results[0] == tt.results[0]
        for (js_, jts), (ts_, tts) in zip(jt.results[1], tt.results[1]):
            np.testing.assert_array_equal(ts_, np.asarray(js_))
            np.testing.assert_array_equal(tts, np.asarray(jts))
    assert [tk.results[0] for tk in tickets["t"]] == ["ok", "redo", "redo"]
    for sm, T in zip(p.oracles, (JT, TT)):
        for (evs, tss), tk in zip(_attach_windows(T), tickets["t"]):
            for e, t, (st, rts) in zip(evs, tss, tk.results[1]):
                want = sm.create_transfers(e, t)
                assert [(int(a), int(b)) for a, b in zip(rts, st)] == \
                    [(r.timestamp, int(r.status)) for r in want]
    # A synchronous window through the attach branch.
    sync = [[TT.Transfer(id=9 * 10 ** 6 + i, debit_account_id=5 + i,
                         credit_account_id=6 + i, amount=3, ledger=1,
                         code=1) for i in range(4)] for _ in range(2)]
    sync[1] = [TT.Transfer(id=9 * 10 ** 6 + 10 + i, debit_account_id=7,
                           credit_account_id=8 + i, amount=2, ledger=1,
                           code=1) for i in range(4)]
    arrays = [JB.transfers_to_arrays(e) for e in sync]
    tss = [10 ** 10, 10 ** 10 + 300]
    j_res = j_led.create_transfers_window(arrays, tss)
    t_res = t_led.create_transfers_window(arrays, tss)
    for (js_, jts), (ts_, tts) in zip(j_res, t_res):
        np.testing.assert_array_equal(ts_, np.asarray(js_))
        np.testing.assert_array_equal(tts, np.asarray(jts))
    p.oracles[1].create_transfers(sync[0], tss[0])
    p.oracles[1].create_transfers(sync[1], tss[1])
    assert t_led.last_window_route == j_led.last_window_route
    t_stats, j_stats = t_led.fallback_stats(), j_led.fallback_stats()
    assert t_stats["routes"] == j_stats["routes"]
    assert t_stats["routes"]["windows"]["partitioned_chain"] >= 3
    assert t_stats["routes"]["chain_batch_fallbacks"].get("e3_limit", 0) >= 1
    assert t_stats["device_telemetry"] == j_stats["device_telemetry"]
    assert t_stats["host_fallbacks"] == j_stats["host_fallbacks"] == 0
    assert p.tr.host_fallbacks == 0 and p.tr.escalations >= 1
    digest = TSE.partitioned_state_digest(t_led.partitioned_state)
    assert digest == JSE.partitioned_state_digest(j_led.partitioned_state)
    assert digest == TSE.partitioned_oracle_digest(p.oracles[1], A_CAP,
                                                   N_DEV)


def test_attach_refuses_write_through_and_the_default_device_raises():
    led = TL.DeviceLedger(A_CAP, T_CAP, write_through=TOracle(),
                          device="cpu")
    router = TP.PartitionedRouter(_tmesh(2), a_cap=A_CAP, t_cap=T_CAP)
    with pytest.raises(AssertionError):
        led.attach_partitioned(router, router.from_oracle(TOracle()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TL.DeviceLedger()
        with pytest.raises(RuntimeError):
            TP.PartitionedRouter(default_mesh())
