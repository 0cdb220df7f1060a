"""Port parity: the partitioned-state mesh route, on the CPU.

The port's `parallel/partitioned.py` against the JAX package's, on the
same state (built by both packages' `partitioned_from_oracle` from two
oracles fed the same operations, and held equal shard by shard) and the
same batches, made with numpy from a seed, at the JAX tests' size
(a_cap 2^9, t_cap 2^11, batches padded to 1,024):

- the per-batch step on meshes of 2 and 8 shards (plain), and of 8 for
  the fixpoint mode (the balancing and imported modes, through the same
  `check_step`, in tests/test_torch_partitioned_tiers.py): statuses,
  timestamps, the fallback and cause flags, the scalars of the out
  dict, the flush gather, the [n_shards, TEL_WORDS] telemetry block,
  every shard's stores below their counts, both hash tables (dump
  bucket aside) and the scalars, and `partitioned_state_digest` equal
  to the JAX package's and to `partitioned_oracle_digest` of the oracle
  that applied the batch. The imported mode holds commit_ts to the
  oracle's (the port's single-chip imported tiers keep it; the JAX
  package keeps the prepare timestamp);
- the chain step on a window of 4 with a limit cascade at prepare 2, on
  meshes of 2 and 8, outputs with their W axis and the [n_shards, W,
  TEL_WORDS] block; the chain over the ledger's lane matrix equal to it;
- the host side: `partitioned_from_oracle`, `_uniq_rows` (inactive
  lanes, ids with the top bit set), `psum` over a mesh of mixed devices,
  `stack_partitioned_window`, the byte counts, `decode_telemetry`;
- the overlay branch (one OVERLAY_MIGRATED entry) on 8 shards;
- a failed batch leaves every shard as it was; shards on two distinct
  devices give the one-device mesh's results.

Every comparison is exact. The JAX steps compile once per (mode, mesh)
in module-level caches, as the JAX package's own partitioned tests and
testing/partitioned_chain_smoke.py share theirs.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.ops import batch as JB
from tigerbeetle_tpu.ops import ledger as JL
from tigerbeetle_tpu.ops import state_epoch as JSE
from tigerbeetle_tpu.oracle import StateMachineOracle as JOracle
from tigerbeetle_tpu.parallel import partitioned as JP
from tigerbeetle_tpu.parallel import shard_utils as JSU
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.convert import (partitioned_from_numpy,
                                           partitioned_to_numpy)
from tigerbeetle_tpu_torch.ops import state_epoch as TSE
from tigerbeetle_tpu_torch.ops.u64 import carrier
from tigerbeetle_tpu_torch.oracle.state_machine import \
    StateMachineOracle as TOracle
from tigerbeetle_tpu_torch.parallel import partitioned as TP
from tigerbeetle_tpu_torch.parallel import shard_utils as TSU

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

A_CAP, T_CAP = 1 << 9, 1 << 11
N_PAD = 1024
TS0 = 10 ** 9
U128_MAX = (1 << 128) - 1
PEND = int(JT.TransferFlags.pending)
POST = int(JT.TransferFlags.post_pending_transfer)
VOID = int(JT.TransferFlags.void_pending_transfer)
IMP = int(JT.TransferFlags.imported)
BAL_DR = int(JT.TransferFlags.balancing_debit)
CLOSE_DR = int(JT.TransferFlags.closing_debit)
DR_LIMIT = int(JT.AccountFlags.debits_must_not_exceed_credits)
OUT_KEYS = ("fallback", "limit_only", "limit_hit", "fix_unconverged",
            "fix_rounds", "created_count", "cross_shard_transfers",
            "exchange_overflow")
LIMITED = (33, 34, 35, 36)
DER_KEYS = ("dr_id_hi", "dr_id_lo", "cr_id_hi", "cr_id_lo", "p_ts")

# Compile-once caches for the JAX steps, shared by every router and test
# of this module.
_JMESH: dict = {}
_JSTEPS: dict = {}
_JCHAIN: dict = {}


def _jmesh(n):
    if n not in _JMESH:
        _JMESH[n] = JMesh(np.array(jax.devices()[:n]), ("batch",))
    return _JMESH[n]


def _jrouter(n, **kw):
    r = JP.PartitionedRouter(_jmesh(n), a_cap=A_CAP, t_cap=T_CAP, **kw)
    r._steps = _JSTEPS.setdefault(n, {})
    r._chain_steps = _JCHAIN.setdefault(n, {})
    return r


def _tmesh(n):
    return TSU.Mesh(["cpu"] * n)


def _xf(T, id_, dr, cr, amt, flags=0, pid=0, ts=0):
    return T.Transfer(id=id_, debit_account_id=dr, credit_account_id=cr,
                      amount=amt, ledger=1, code=1, flags=flags,
                      pending_id=pid, timestamp=ts)


def _accounts(T):
    return [T.Account(id=i, ledger=1, code=1,
                      flags=DR_LIMIT if i in LIMITED else 0)
            for i in range(1, 41)]


def _setup_ops(T):
    """The pre-state's operations: 40 accounts (33-36 debit-limited and
    funded with 100), committed pendings 5000-5011 over many shards, and
    a transient failure (an orphaned id)."""
    fund = [_xf(T, 4000 + i, 1 + i, a, 100)
            for i, a in enumerate(LIMITED)]
    pend = [_xf(T, 5000 + i, 1 + (3 * i) % 30, 2 + (7 * i) % 30, 10 + i,
                flags=PEND) for i in range(12)]
    orphan = [_xf(T, 6000, 33, 1, 10 ** 6)]          # exceeds_credits
    return [fund + pend + orphan]


def _oracles():
    """The JAX package's and the port's oracle after the same setup."""
    out = []
    for O, T in ((JOracle, JT), (TOracle, TT)):
        sm = O()
        sm.create_accounts(_accounts(T), 50)
        ts = TS0
        for batch in _setup_ops(T):
            ts += 1000
            sm.create_transfers(batch, ts)
        out.append(sm)
    return out


def _pairs(rng, count, ids=range(1, 33)):
    ids = np.asarray(list(ids))
    out = []
    for _ in range(count):
        dr, cr = rng.choice(ids, 2, replace=False)
        out.append((int(dr), int(cr)))
    return out


def _batch(T, mode: str, seed: int) -> list:
    """One batch of `mode`'s traffic over many shards, seeded: uniform
    transfers (1 in 4 pending), an unknown account, posts and voids of
    the committed pendings, a duplicate id of a committed transfer, the
    orphaned id again, and the mode's own lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (dr, cr) in enumerate(_pairs(rng, 96)):
        out.append(_xf(T, 10_000 + i, dr, cr, int(rng.integers(1, 40)),
                       flags=PEND if rng.random() < 0.25 else 0))
    out[7] = _xf(T, 10_007, 1, 77, 5)                       # unknown
    out[11] = _xf(T, 10_011, 0, 0, U128_MAX, flags=POST, pid=5000)
    out[29] = _xf(T, 10_029, 0, 0, 0, flags=VOID, pid=5003)
    out[44] = _xf(T, 10_044, 0, 0, U128_MAX, flags=POST, pid=5007)
    out[63] = _xf(T, 4001, 2, 34, 100)                      # exists
    out[80] = _xf(T, 6000, 33, 1, 10 ** 6)                  # orphan
    if mode == "fixpoint":
        # A limit cascade on a limited account, an in-batch pending
        # posted and another voided later in the batch, a closing
        # pending.
        for j, lane in enumerate((3, 19, 35, 51, 67, 83)):
            out[lane] = _xf(T, 11_000 + j, 33, 4 + j, 30)
        out[5] = _xf(T, 12_000, 1, 2, 40, flags=PEND)
        out[70] = _xf(T, 12_001, 0, 0, U128_MAX, flags=POST, pid=12_000)
        out[20] = _xf(T, 12_002, 3, 4, 7, flags=PEND)
        out[95] = _xf(T, 12_003, 0, 0, 0, flags=VOID, pid=12_002)
        out[60] = _xf(T, 12_004, 37, 5, 1, flags=PEND | CLOSE_DR)
    elif mode == "balancing":
        for j, lane in enumerate((9, 30, 58, 91)):
            out[lane] = _xf(T, 13_000 + j, LIMITED[j % 4], 6 + j, 1_000,
                            flags=BAL_DR)
    elif mode == "imported":
        # A whole imported batch: user timestamps rising between the
        # setup's and the prepare's, one regress lane.
        base = TS0 + 5_000
        out = [_xf(T, 14_000 + i, e.debit_account_id,
                   e.credit_account_id, e.amount, flags=IMP,
                   ts=base + 3 * i)
               for i, e in enumerate(out)
               if e.pending_id == 0 and e.debit_account_id != 0
               and e.id != 4001 and e.id != 6000]
        out[50] = _xf(T, 14_999, 1, 2, 5, flags=IMP, ts=base + 3 * 10)
    return out


def _jstate_np(jstate):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))


def _assert_states_equal(got: dict, want: dict, commit: bool = True):
    """Stacked numpy partitioned states, shard by shard: every store's
    rows below its count, the counts, both hash tables but the dump
    bucket, the scalars (commit_ts unless `commit` is off)."""
    n = want["accounts"]["count"].shape[0]
    for s in range(n):
        for store in ("accounts", "transfers", "events"):
            c = int(want[store]["count"][s])
            assert int(got[store]["count"][s]) == c, (s, store)
            for k, w in want[store].items():
                if k == "count":
                    continue
                np.testing.assert_array_equal(
                    got[store][k][s][:c], w[s][:c],
                    err_msg=f"shard {s} {store}.{k}")
        for table in ("acct_ht", "xfer_ht"):
            np.testing.assert_array_equal(
                got[table]["packed"][s][:-1], want[table]["packed"][s][:-1],
                err_msg=f"shard {s} {table}")
        for k in ("acct_key_max", "xfer_key_max", "pulse_next") + (
                ("commit_ts",) if commit else ()):
            assert int(got[k][s]) == int(want[k][s]), (s, k)


def _assert_outs_equal(t_out: dict, j_out: dict, tag: str):
    """The port's out (tensors) vs the JAX package's (fetched)."""
    np.testing.assert_array_equal(
        t_out["r_status"].numpy(),
        np.asarray(j_out["r_status"]).astype(np.int64), err_msg=tag)
    np.testing.assert_array_equal(
        t_out["r_ts"].numpy().view(np.uint64), np.asarray(j_out["r_ts"]),
        err_msg=tag)
    for k in OUT_KEYS:
        np.testing.assert_array_equal(
            t_out[k].numpy().astype(np.int64),
            np.asarray(j_out[k]).astype(np.int64), err_msg=f"{tag} {k}")
    assert set(t_out["fb_causes"]) == set(j_out["fb_causes"]), tag
    for k, v in j_out["fb_causes"].items():
        np.testing.assert_array_equal(t_out["fb_causes"][k].numpy(),
                                      np.asarray(v), err_msg=f"{tag} {k}")
    flush_t, flush_j = t_out["flush"], j_out["flush"]
    for part in ("t", "e"):
        np.testing.assert_array_equal(
            flush_t[part].numpy().view(np.uint64), np.asarray(flush_j[part]),
            err_msg=f"{tag} flush {part}")
    # The port stacks the derived gathers as columns of one matrix.
    for i, k in enumerate(DER_KEYS):
        np.testing.assert_array_equal(
            flush_t["der"][..., i].numpy().view(np.uint64),
            np.asarray(flush_j[k]), err_msg=f"{tag} flush {k}")
    sh_t, sh_j = t_out["shard_stats"], j_out["shard_stats"]
    np.testing.assert_array_equal(sh_t["events_owned"].numpy(),
                                  np.asarray(sh_j["events_owned"]),
                                  err_msg=f"{tag} events_owned")
    np.testing.assert_array_equal(
        sh_t["tel"].numpy().astype(np.uint32), np.asarray(sh_j["tel"]),
        err_msg=f"{tag} tel")


def _flush_np(flush):
    """The JAX package's flush with its row matrices unwrapped."""
    return {k: (v["u64"] if isinstance(v, dict) else v)
            for k, v in flush.items()}


# ------------------------------------------------------------- fixtures

def pre_states(sizes=(2, 8)):
    """(JAX oracle, port oracle, {n: stacked numpy pre-state}): the port's
    `partitioned_from_oracle`, which test_from_oracle_equals_the_jax_
    packages holds equal to the JAX package's."""
    j_sm, t_sm = _oracles()
    states = {n: partitioned_to_numpy(TP.partitioned_from_oracle(
        t_sm, _tmesh(n), A_CAP, T_CAP)) for n in sizes}
    return j_sm, t_sm, states


@pytest.fixture(scope="module")
def pre():
    return pre_states()


def run_step(pre, n, mode, events_of, ts):
    """One batch through both packages' per-batch step from the same
    pre-state; returns (port state, port out, JAX state, JAX out, the
    oracles after the batch)."""
    j_sm, t_sm, states = pre
    j_sm, t_sm = _oracles()
    ev = JL.pad_transfer_events(JB.transfers_to_arrays(events_of(JT)),
                                N_PAD)
    nn = len(events_of(JT))
    t_state = partitioned_from_numpy(states[n], _tmesh(n))
    t_step = TP.make_partitioned_create_transfers(_tmesh(n), mode=mode)
    t_state, t_out = t_step(t_state, ev, ts, nn)
    jr = _jrouter(n)
    j_state = jax.device_put(states[n], jax.sharding.NamedSharding(
        _jmesh(n), jax.sharding.PartitionSpec("batch")))
    j_state, j_out = jr._step(mode)(j_state, ev, np.uint64(ts), np.int32(nn))
    j_out = jax.device_get(j_out)
    j_out["flush"] = _flush_np(j_out["flush"])
    want = j_sm.create_transfers(events_of(JT), ts)
    t_sm.create_transfers(events_of(TT), ts)
    return t_state, t_out, _jstate_np(j_state), j_out, j_sm, t_sm, want


def check_step(pre, n, mode):
    """One mode's batch through both packages' steps: outputs, results
    against the oracle, states, digests."""
    ts = TS0 + 50_000
    (t_state, t_out, j_state, j_out, j_sm, t_sm,
     want) = run_step(pre, n, mode, lambda T: _batch(T, mode, 7 + n), ts)
    tag = f"{mode}/{n}"
    assert not bool(t_out["fallback"]), {
        k: bool(v) for k, v in t_out["fb_causes"].items()}
    _assert_outs_equal(t_out, j_out, tag)
    nn = len(want)
    got = [(int(t) & ((1 << 64) - 1), int(s)) for s, t in zip(
        t_out["r_status"][:nn].tolist(), t_out["r_ts"][:nn].tolist())]
    assert got == [(r.timestamp, int(r.status)) for r in want], tag
    imported = mode == "imported"
    _assert_states_equal(partitioned_to_numpy(t_state), j_state,
                         commit=not imported)
    digest = TSE.partitioned_state_digest(t_state)
    assert digest == TSE.partitioned_oracle_digest(t_sm, A_CAP, n), tag
    j_digest = JSE.partitioned_state_digest(jax.device_put(j_state))
    if imported:
        assert {k: v for k, v in digest.items() if k != "scalars"} == \
            {k: v for k, v in j_digest.items() if k != "scalars"}
    else:
        assert digest == j_digest, tag
    assert j_digest == JSE.partitioned_oracle_digest(j_sm, A_CAP, n) or \
        imported
    # The oracle digests of the two packages' oracles agree.
    assert (TSE.partitioned_oracle_digest(t_sm, A_CAP, n)
            == JSE.partitioned_oracle_digest(t_sm, A_CAP, n))


# The balancing and imported modes run in test_torch_partitioned_tiers.py
# (their JAX steps take ~35 s each to compile).
@pytest.mark.parametrize("n, mode", [(2, "plain"), (8, "plain"),
                                     (8, "fixpoint")])
def test_step_equals_the_jax_packages(pre, n, mode):
    check_step(pre, n, mode)


def test_failed_batch_leaves_every_shard_as_it_was(pre):
    """A batch that falls back (a hard imported flag on the plain step)
    writes nothing below the counts: every shard's stores, tables and
    scalars stay bit-identical, and the telemetry names the cause."""
    j_sm, t_sm, states = pre
    events = _batch(JT, "plain", 3)
    events[40] = _xf(JT, 20_000, 1, 2, 3, flags=IMP, ts=TS0 + 1)
    ev = JL.pad_transfer_events(JB.transfers_to_arrays(events), N_PAD)
    t_state = partitioned_from_numpy(states[8], _tmesh(8))
    before = partitioned_to_numpy(t_state)
    step = TP.make_partitioned_create_transfers(_tmesh(8))
    t_state, out = step(t_state, ev, TS0 + 90_000, len(events))
    assert bool(out["fallback"]) and bool(out["fb_causes"]["e1_hard_flags"])
    assert int(out["r_status"].abs().sum()) == 0
    _assert_states_equal(partitioned_to_numpy(t_state), before)
    tel = TP.decode_telemetry(out["shard_stats"]["tel"])
    assert (tel["poison_cause"] == 1 + TP.TEL_CAUSES.index(
        "e1_hard_flags")).all()
    assert (tel["writeback_transfers"] == 0).all()


def _chain_window(T, rng_seed, n):
    """A window of 4 prepares over many shards; prepare 2 debits a
    limited account past its funding (the plain tier's headroom proof
    falls back limit_only, poisoning the chain there)."""
    rng = np.random.default_rng(rng_seed)
    w = []
    nid = 30_000
    for b in range(4):
        evs = [_xf(T, nid + i, dr, cr, int(rng.integers(1, 30)),
                   flags=PEND if b == 0 and i % 3 == 0 else 0)
               for i, (dr, cr) in enumerate(_pairs(rng, 24))]
        nid += 24
        if b == 2:
            evs.append(_xf(T, nid, 33, 9, 10 ** 6))
            nid += 1
        if b == 3:
            evs.append(_xf(T, nid, 0, 0, U128_MAX, flags=POST, pid=30_000))
            nid += 1
        w.append(evs)
    tss = [TS0 + 60_000 + 300 * b for b in range(4)]
    return w, tss


@pytest.mark.parametrize("n", [2, 8])
def test_chain_step_equals_the_jax_packages(pre, n):
    j_sm, t_sm, states = pre
    w, tss = _chain_window(JT, 41, n)
    arrays = [JB.transfers_to_arrays(e) for e in w]
    j_stacks = JP.stack_partitioned_window(arrays, tss, N_PAD)
    t_stacks = TP.stack_partitioned_window(arrays, tss, N_PAD)
    for a, b in zip(jax.tree_util.tree_leaves(j_stacks),
                    jax.tree_util.tree_leaves(t_stacks)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    t_state = partitioned_from_numpy(states[n], _tmesh(n))
    t_step = TP.make_partitioned_chain_create_transfers(_tmesh(n))
    t_state, t_out = t_step(t_state, *t_stacks)
    jr = _jrouter(n)
    j_state = jax.device_put(states[n], jax.sharding.NamedSharding(
        _jmesh(n), jax.sharding.PartitionSpec("batch")))
    j_state, j_out = jr._chain_step("plain")(j_state, *j_stacks, None)
    j_out = jax.device_get(j_out)
    j_out["flush"] = _flush_np(j_out["flush"])
    fb = t_out["fallback"].numpy()
    assert fb.tolist() == [False, False, True, True], fb
    assert bool(t_out["fb_causes"]["e3_limit"][2])
    assert bool(t_out["fb_causes"]["forced"][3])
    _assert_outs_equal(t_out, j_out, f"chain/{n}")
    assert t_out["shard_stats"]["tel"].shape == (n, 4, TP.TEL_WORDS)
    _assert_states_equal(partitioned_to_numpy(t_state),
                         _jstate_np(j_state))
    # The chain over the ledger's lane matrix runs the same window.
    t_state2 = partitioned_from_numpy(states[n], _tmesh(n))
    lanes = TP.PartitionedRouter(_tmesh(n), a_cap=A_CAP,
                                 t_cap=T_CAP).stage_operands(
        arrays, tss, N_PAD)
    out2 = t_step.lanes(t_state2, lanes)
    for k in ("r_status", "r_ts", "fallback", "created_count"):
        assert torch.equal(out2[k], t_out[k]), k
    assert torch.equal(out2["shard_stats"]["tel"],
                       t_out["shard_stats"]["tel"])
    _assert_states_equal(partitioned_to_numpy(t_state2),
                         partitioned_to_numpy(t_state))


# ----------------------------------------------------------- host side

def test_from_oracle_equals_the_jax_packages(pre):
    """On 8 shards every leaf of the port's partitioned_from_oracle equals
    the JAX package's (tables, rings, dump rows and all); on 2 and 8
    shards each shard's canonical pack equals the JAX package's pack and
    the port's stored rows below the counts equal it, and the digests
    agree."""
    j_sm, t_sm, states = pre
    want = _jstate_np(JP.partitioned_from_oracle(
        j_sm, _jmesh(8), a_cap=A_CAP, t_cap=T_CAP))
    got = states[8]
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for n in (2, 8):
        packs_t = TSE.pack_oracle_state_partitioned(t_sm, A_CAP, n)
        packs_j = JSE.pack_oracle_state_partitioned(j_sm, A_CAP, n)
        for s, (pt, pj) in enumerate(zip(packs_t, packs_j)):
            for a, b in zip(jax.tree_util.tree_leaves(pt),
                            jax.tree_util.tree_leaves(pj)):
                np.testing.assert_array_equal(a, b)
            for store, keys in (("accounts", ("u64", "bal")),
                                ("transfers", ("u64",))):
                c = int(pj[store]["count"])
                assert int(states[n][store]["count"][s]) == c
                for k in keys:
                    np.testing.assert_array_equal(
                        states[n][store][k][s][:c], pj[store][k],
                        err_msg=f"shard {s} {store}.{k}")
        assert (TSE.partitioned_state_digest(partitioned_from_numpy(
            states[n], _tmesh(n)))
            == TSE.partitioned_oracle_digest(t_sm, A_CAP, n)
            == JSE.partitioned_oracle_digest(j_sm, A_CAP, n))
    with pytest.raises(ValueError):
        TP.partitioned_from_oracle(t_sm, _tmesh(8), 100, T_CAP)


def test_uniq_rows_equals_the_jax_packages():
    rng = np.random.default_rng(5)
    n = 512
    hi = rng.integers(0, 4, n, dtype=np.uint64)
    lo = rng.integers(0, 40, n, dtype=np.uint64)
    hi[::7] |= np.uint64(1 << 63)          # ids with the top bit set
    lo[::11] = np.uint64((1 << 64) - 1)
    hi[5] = lo[5] = np.uint64((1 << 64) - 1)   # the max key, active
    active = rng.random(n) < 0.7
    active[:3] = False
    want = [np.asarray(x) for x in JP._uniq_rows(hi, lo, active)]
    got = [x.numpy() for x in TP._uniq_rows(
        carrier(hi, "cpu"), carrier(lo, "cpu"), torch.from_numpy(active))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert int(got[2]) == int(want[2])
    assert got[1].dtype == np.int32 and got[2].dtype == np.int32


def test_psum_over_a_mesh_of_mixed_devices():
    mesh = TSU.Mesh(["cpu", "cpu:0", "cpu", "cpu:0"])
    assert len(mesh.distinct) == 2
    rng = np.random.default_rng(9)
    parts_np = [rng.integers(0, 2 ** 64, (16, 3), dtype=np.uint64)
                for _ in range(4)]
    parts_np[1][0, 0] = np.uint64((1 << 64) - 1)   # wraps
    parts = [carrier(p, d) for p, d in zip(parts_np, mesh.devices)]
    want = parts_np[0].copy()
    for p in parts_np[1:]:
        want = want + p                              # uint64 wraps
    out = TSU.psum(mesh, parts)
    assert len(out) == 2
    for t, d in zip(out, mesh.distinct):
        assert t.device.type == torch.device(d).type
        np.testing.assert_array_equal(t.numpy().view(np.uint64), want)
    b = TSU.psum(mesh, [torch.tensor([True, False])] * 4)
    assert b[0].tolist() == [4, 0]
    with pytest.raises(ValueError):
        TSU.psum(mesh, parts[:3])


def test_bytes_scale_and_telemetry_decode(pre):
    j_sm, t_sm, states = pre
    for n in (2, 8):
        st = partitioned_from_numpy(states[n], _tmesh(n))
        pb = TP.partitioned_state_bytes(st)
        assert pb == JP.partitioned_state_bytes(states[n])
        rb = TP.replicated_state_bytes(A_CAP, T_CAP)
        assert rb == JP.replicated_state_bytes(A_CAP, T_CAP)
        assert pb <= rb // n + rb // 50, (pb, rb, n)
    tel = np.arange(2 * 3 * TP.TEL_WORDS, dtype=np.uint32).reshape(
        2, 3, TP.TEL_WORDS)
    got, want = TP.decode_telemetry(tel), JP.decode_telemetry(tel)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert (TP.TEL_LAYOUT, TP.TEL_WORDS, TP.TEL_CAUSES) == (
        JP.TEL_LAYOUT, JP.TEL_WORDS, JP.TEL_CAUSES)
    assert TP.decode_telemetry(torch.from_numpy(tel.astype(np.int64)))[
        "events_owned"].tolist() == want["events_owned"].tolist()


# -------------------------------------------------------------- overlay

def test_overlay_step_equals_the_jax_packages():
    """One OVERLAY_MIGRATED entry: from_oracle places the range on its
    read owner, and the step built with the overlay equals the JAX
    package's built with the same overlay."""
    n = 8
    entry = (0, (1 << 62) - 1, 1, 6, JSU.OVERLAY_MIGRATED)
    table_t = TSU.OwnershipTable(n).with_entry(*entry)
    table_j = JSU.OwnershipTable(n).with_entry(*entry)
    j_sm, t_sm = _oracles()
    jr = _jrouter(n)
    jr.set_ownership(table_j)
    tr = TP.PartitionedRouter(_tmesh(n), a_cap=A_CAP, t_cap=T_CAP)
    tr.set_ownership(table_t)
    j_state = jr.from_oracle(j_sm)
    t_state = tr.from_oracle(t_sm)
    _assert_states_equal(partitioned_to_numpy(t_state),
                         _jstate_np(j_state))
    events = _batch(JT, "plain", 77)
    ev = JL.pad_transfer_events(JB.transfers_to_arrays(events), N_PAD)
    ts = TS0 + 70_000
    t_state, t_out, t_fb = tr.step(t_state, ev, ts, len(events))
    j_state, j_out, j_fb = jr.step(j_state, ev, ts, len(events))
    j_out = jax.device_get(j_out)
    j_out["flush"] = _flush_np(j_out["flush"])
    assert t_fb == j_fb
    _assert_outs_equal(t_out, j_out, "overlay")
    _assert_states_equal(partitioned_to_numpy(t_state),
                         _jstate_np(j_state))
    want = t_sm.create_transfers(_batch(TT, "plain", 77), ts)
    got = [(int(t) & ((1 << 64) - 1), int(s)) for s, t in zip(
        t_out["r_status"][:len(want)].tolist(),
        t_out["r_ts"][:len(want)].tolist())]
    assert got == [(r.timestamp, int(r.status)) for r in want]
    assert (TSE.partitioned_state_digest(t_state)
            == TSE.partitioned_oracle_digest(t_sm, A_CAP, n,
                                             table_t.entries))
    assert tr.stats() == jr.stats()


def test_a_mesh_of_two_distinct_devices_runs_the_same_step(pre):
    """Shards on two distinct devices ("cpu" and "cpu:0": the judge runs
    once a distinct device, `psum` places the sums on both) give the
    one-device mesh's results, telemetry and states, on the per-batch
    step and the chain."""
    j_sm, t_sm, states = pre
    one, two = _tmesh(8), TSU.Mesh(["cpu", "cpu:0"] * 4)
    assert len(two.distinct) == 2
    events = _batch(JT, "fixpoint", 21)
    ev = JL.pad_transfer_events(JB.transfers_to_arrays(events), N_PAD)
    w, tss = _chain_window(JT, 43, 8)
    stacks = TP.stack_partitioned_window(
        [JB.transfers_to_arrays(e) for e in w], tss, N_PAD)
    outs = []
    for mesh in (one, two):
        st = partitioned_from_numpy(states[8], mesh)
        st, out = TP.make_partitioned_create_transfers(
            mesh, mode="fixpoint")(st, ev, TS0 + 80_000, len(events))
        st, chain = TP.make_partitioned_chain_create_transfers(mesh)(
            st, *stacks)
        outs.append((partitioned_to_numpy(st), out, chain))
    _assert_states_equal(outs[1][0], outs[0][0])
    for k in ("r_status", "r_ts", "fallback", "fix_rounds"):
        assert torch.equal(outs[1][1][k], outs[0][1][k]), k
        assert torch.equal(outs[1][2][k], outs[0][2][k]), k
    assert torch.equal(outs[1][1]["shard_stats"]["tel"],
                       outs[0][1]["shard_stats"]["tel"])
    assert torch.equal(outs[1][2]["shard_stats"]["tel"],
                       outs[0][2]["shard_stats"]["tel"])


def test_static_cost_model_counts_the_partitioned_chain_on_a_mesh():
    """The cost model's partitioned_chain tier runs on a mesh of more
    than one shard (skipped on one, as the JAX package skips it on small
    meshes): a chain of `depth` plain prepares on 8 shards calls the
    probe once a prepare and the row gather 3 x 8 + 4 + 6 = 34 times a
    prepare."""
    from tigerbeetle_tpu_torch.trace import profiler as TPF

    depth = 2
    model = TPF.static_cost_model(depth=depth, device="cpu",
                                  caps=(1 << 10, 1 << 12), batch=256,
                                  mesh=_tmesh(8))
    row = model["tiers"]["partitioned_chain"]
    assert row["kernel_calls"] == {"ht_probe": depth,
                                   "row_gather": 34 * depth}
    assert row["launches"] == {"ht_probe": 0, "row_gather": 0}
    assert row["flops"] > 0 and row["hbm_bytes"] > row["kernel_bytes"] > 0
    one = TPF.static_cost_model(depth=depth, device="cpu",
                                caps=(1 << 10, 1 << 12), batch=256,
                                mesh=_tmesh(1))
    assert set(one["tiers"]) == {"flat", "chain"}
    assert TPF.TIER_ENTRIES["partitioned_chain"] == \
        "make_partitioned_chain_create_transfers"
