"""Port parity: live resharding (`parallel/resharding.py`) and its range
digests (`ops/state_epoch.py`), on the CPU.

The port on logical shards of the CPU against the JAX package on its
virtual CPU devices, from the same numpy inputs (the partitioned
pre-state of tests/test_torch_partitioned.py, carried across with
`convert.partitioned_from_numpy`), exact everywhere:

- the range digests (`partitioned_range_digest`, `oracle_range_digest`,
  `sum_range_components`) for plans with hi below and above 2^63 and each
  source shard, on meshes of 2 and 8;
- each device kernel against its JAX function: a snapshot of the range,
  its rows installed on the receiver (`_install_chunk`), the receiver
  finalized (`_finalize_shard`), the source retired and the receiver
  evicted (`_evict_range`), each compared shard by shard (stores below
  their counts, tables but the dump bucket); `_drop_range_keys`,
  `_remap_table_vals` and `_sort_store` on their own;
- the controller end to end (the port's testing/reshard_smoke.py, run
  below with the JAX package's controller stepped beside it in lockstep,
  at the seeds of the JAX package's reshard_smoke): a split, a migrate
  and a merge_back under
  live traffic on a mesh of 2 (of 8 in
  tests/test_torch_resharding_mesh8.py), and a corrupted chunk that aborts
  before the flip; both packages' controllers step through the same
  windows, and each window's results, each stage's records and each
  digest are equal, the port's storage unmoved;
- `reshard_chaos_scenario` against the JAX package's for three seeds;
- the CPU counterparts of the JAX package's tests/test_resharding.py.

The JAX steps are compiled once a mesh size in this module's caches (one
chain step an overlay), shared by the controller runs and the chaos
seeds; the JAX controller at mesh 2 takes ~100 s to compile them.
"""

import dataclasses
import glob
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.ops import batch as JB
from tigerbeetle_tpu.ops import state_epoch as JSE
from tigerbeetle_tpu.oracle import StateMachineOracle as JOracle
from tigerbeetle_tpu.parallel import partitioned as JP
from tigerbeetle_tpu.parallel import resharding as JR
from tigerbeetle_tpu.parallel import shard_utils as JSU
from tigerbeetle_tpu.testing import chaos as JCH
from tigerbeetle_tpu import types as JT
from tigerbeetle_tpu_torch.convert import (partitioned_from_numpy,
                                           partitioned_to_numpy)
from tigerbeetle_tpu_torch.ops import state_epoch as TSE
from tigerbeetle_tpu_torch.ops.u64 import carrier
from tigerbeetle_tpu_torch.ops.window_graph import state_signature
from tigerbeetle_tpu_torch.parallel import partitioned as TP
from tigerbeetle_tpu_torch.parallel import resharding as TR
from tigerbeetle_tpu_torch.parallel import shard_utils as TSU
from tigerbeetle_tpu_torch.testing import chaos as TCH
from tigerbeetle_tpu_torch.testing import reshard_smoke as RS
from tests.test_torch_partitioned import (A_CAP, T_CAP, _assert_states_equal,
                                          _jmesh, _jstate_np, _tmesh,
                                          pre_states)

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

U64MAX = (1 << 64) - 1
U128MAX = (1 << 128) - 1
HALF = 1 << 63
N_ACCTS = 40

# The JAX routers' step caches, a mesh size each (the steps close over
# the mesh and key on (mode, overlay entries)).
_JCACHES: dict = {}


def _jrouter(n, **kw):
    r = JP.PartitionedRouter(_jmesh(n), a_cap=A_CAP, t_cap=T_CAP, **kw)
    r._steps, r._chain_steps = _JCACHES.setdefault(n, ({}, {}))
    return r


def _jput(np_state, n):
    return jax.device_put(np_state, NamedSharding(_jmesh(n),
                                                  PartitionSpec("batch")))


@pytest.fixture(scope="module")
def pre():
    return pre_states()


def _plans(n):
    """Ranges below, across and above 2^63, from each source shard."""
    out = []
    for src in range(n):
        dst = (src + 1) % n
        out += [(0, HALF - 1, src, dst), (HALF, U64MAX, src, dst),
                (1 << 61, (1 << 63) + (1 << 62), src, dst)]
    return out


# ---------------------------------------------------------- range digests

@pytest.mark.parametrize("n", [2, 8])
def test_range_digests_equal_the_jax_packages(pre, n):
    j_sm, t_sm, states = pre
    t_state = partitioned_from_numpy(states[n], _tmesh(n))
    j_state = _jput(states[n], n)
    for lo, hi, src, _dst in _plans(n):
        got = TSE.partitioned_range_digest(t_state, lo, hi, src)
        want = JSE.partitioned_range_digest(j_state, lo, hi, src)
        assert got == want, (lo, hi, src)
        # The rows are in one shard: the wrap-sum of the shards' folds is
        # the oracle's whole-state fold, in both packages.
        o_t = TSE.oracle_range_digest(t_sm, A_CAP, lo, hi, src, n)
        o_j = JSE.oracle_range_digest(j_sm, A_CAP, lo, hi, src, n)
        assert o_t == o_j == TSE.sum_range_components(got) == \
            JSE.sum_range_components(want)
        assert got[src] == o_t, (lo, hi, src)
        assert all(got[s]["accounts_rows"] == 0 for s in range(n)
                   if s != src)
    # Rows hash on both sides of 2^63.
    for below in (True, False):
        assert any(TSE.oracle_range_digest(t_sm, A_CAP, lo, hi, src, n)
                   ["transfers_rows"] for lo, hi, src, _ in _plans(n)
                   if (hi < HALF) == below)


# ---------------------------------------------------------- device kernels

def _t_router(n, **kw):
    return TP.PartitionedRouter(_tmesh(n), a_cap=A_CAP, t_cap=T_CAP, **kw)


def _snapshots(states, n, plan, j_sm, t_sm):
    """Both packages' snapshots of `plan`'s range on its source."""
    t_state = partitioned_from_numpy(states[n], _tmesh(n))
    j_state = _jput(states[n], n)
    t_ctl = TR.ReshardController(_t_router(n))
    j_ctl = JR.ReshardController(_jrouter(n))
    t_ctl.plan = j_ctl.plan = plan
    t_snap = t_ctl._take_snapshot(t_state, plan.src, t_sm)
    j_snap = j_ctl._take_snapshot(j_state, plan.src, j_sm)
    return t_snap, j_snap


@pytest.mark.parametrize("n, lo, hi", [
    (2, 0, HALF - 1), (8, HALF, U64MAX),
    (8, 1 << 61, (1 << 63) + (1 << 62))])
def test_kernels_equal_the_jax_packages(pre, n, lo, hi):
    """A range's snapshot (from the first source shard with accounts and
    transfers in it), installed on the receiver in chunks, finalized,
    retired from the source; and evicted from the receiver (an abort's
    eviction): every shard equal to the JAX package's after each kernel,
    and the port's storage unmoved."""
    j_sm, t_sm, states = pre
    src = next(s for s in range(n) if all(
        TSE.oracle_range_digest(t_sm, A_CAP, lo, hi, s, n)[k]
        for k in ("accounts_rows", "transfers_rows")))
    plan = TR.ReshardPlan(lo, hi, src, (src + 3) % n)
    t_snap, j_snap = _snapshots(states, n, plan, j_sm, t_sm)
    for k in ("a_u64", "a_bal", "x_u64", "e_u64", "o_hi", "o_lo"):
        np.testing.assert_array_equal(t_snap[k], j_snap[k], err_msg=k)
    assert t_snap["digest"] == j_snap["digest"]
    assert len(t_snap["x_u64"]) and len(t_snap["a_u64"])
    assert len(t_snap["o_hi"]) <= 1

    t_state = partitioned_from_numpy(states[n], _tmesh(n))
    sig = state_signature(t_state)
    j_state = _jput(states[n], n)
    dev = torch.device("cpu")
    C = 32
    na, nx, ne = (len(t_snap[k]) for k in ("a_u64", "x_u64", "e_u64"))
    for c0 in range(0, max(na, nx, ne), C):
        def chunk(key, ncols):
            rows = np.zeros((C, ncols), dtype=np.uint64)
            part = t_snap[key][c0:c0 + C]
            rows[:len(part)] = part
            return rows, np.int32(len(part))

        a_rows, a_n = chunk("a_u64", t_snap["a_u64"].shape[1])
        a_bal, _ = chunk("a_bal", 16)
        x_rows, x_n = chunk("x_u64", t_snap["x_u64"].shape[1])
        e_rows, e_n = chunk("e_u64", t_snap["e_u64"].shape[1])
        TR._install_chunk(t_state[plan.dst], carrier(a_rows, dev),
                          carrier(a_bal, dev), int(a_n), carrier(x_rows, dev),
                          int(x_n), carrier(e_rows, dev), int(e_n))
        j_state = JR._install_chunk(j_state, np.int32(plan.dst), a_rows,
                                    a_bal, a_n, x_rows, x_n, e_rows, e_n)
        _assert_states_equal(partitioned_to_numpy(t_state),
                             _jstate_np(j_state))
    o_hi = np.zeros(2, dtype=np.uint64)
    o_lo = np.zeros(2, dtype=np.uint64)
    n_o = len(t_snap["o_hi"])
    o_hi[:n_o], o_lo[:n_o] = t_snap["o_hi"], t_snap["o_lo"]
    ok_t = TR._finalize_shard(t_state[plan.dst], carrier(o_hi, dev),
                              carrier(o_lo, dev), n_o)
    j_state, ok_j = JR._finalize_shard(j_state, np.int32(plan.dst), o_hi,
                                       o_lo, np.int32(n_o))
    assert bool(ok_t) and bool(ok_j)
    _assert_states_equal(partitioned_to_numpy(t_state), _jstate_np(j_state))
    # Source and receiver hold the range equally now.
    got = TSE.partitioned_range_digest(t_state, plan.lo, plan.hi, plan.src)
    assert got[plan.src] == got[plan.dst] == t_snap["digest"]
    assert got == JSE.partitioned_range_digest(j_state, plan.lo, plan.hi,
                                               plan.src)
    for shard in (plan.src, plan.dst):   # the retire, then an abort's
        TR._evict_range(t_state[shard], plan.lo, plan.hi, n, plan.src)
        j_state = JR._evict_range(j_state, np.int32(shard),
                                  np.uint64(plan.lo), np.uint64(plan.hi), n,
                                  np.int32(plan.src))
        _assert_states_equal(partitioned_to_numpy(t_state),
                             _jstate_np(j_state))
    got = TSE.partitioned_range_digest(t_state, plan.lo, plan.hi, plan.src)
    assert all(d["accounts_rows"] == d["transfers_rows"] == 0 for d in got)
    assert state_signature(t_state) == sig


def _random_table(rng, n_buckets, n_keys):
    """A packed table of one shard with live keys, orphan markers and
    empty slots, every bucket a prefix of its slots."""
    slots = TR.SLOTS
    packed = np.zeros((n_buckets + 1, 3 * slots), dtype=np.uint64)
    for b in range(n_buckets):
        k = int(rng.integers(0, slots + 1))
        for j in range(k):
            packed[b, j] = rng.integers(0, 1 << 64, dtype=np.uint64)
            packed[b, slots + j] = rng.integers(1, 1 << 64,
                                                dtype=np.uint64)
            v = (int(rng.integers(0, n_keys)) if rng.random() < 0.8
                 else -2)
            packed[b, 2 * slots + j] = np.int64(v).astype(np.uint64)
    return packed


@pytest.mark.parametrize("n", [2, 8])
def test_table_and_sort_kernels_equal_the_jax_packages(n):
    rng = np.random.default_rng(5 + n)
    packed = _random_table(rng, 64, 300)
    perm = rng.permutation(300)
    newpos = np.zeros(300, dtype=np.int32)
    newpos[perm] = np.arange(300, dtype=np.int32)
    t_packed = carrier(packed, "cpu")
    np.testing.assert_array_equal(
        TR._remap_table_vals(t_packed, carrier(newpos, "cpu")).numpy().view(
            np.uint64),
        np.asarray(JR._remap_table_vals(packed, newpos)))
    for lo, hi, src, _ in _plans(n)[:6]:
        np.testing.assert_array_equal(
            TR._drop_range_keys(t_packed, lo, hi, src, n).numpy().view(
                np.uint64),
            np.asarray(JR._drop_range_keys(packed, np.uint64(lo),
                                           np.uint64(hi), src, n)),
            err_msg=f"{lo:#x} {hi:#x} {src}")
    u64 = rng.integers(0, 1 << 64, (96, 6), dtype=np.uint64)
    u64[:, 3] = rng.permutation(10 ** 12 + np.arange(96)).astype(np.uint64)
    u64[5, 3] = np.uint64(U64MAX)   # a live row keyed u64::MAX
    for count in (0, 40, 95):
        t_out = TR._sort_store(carrier(u64, "cpu"), count, 3)
        j_out = JR._sort_store(u64, np.int32(count), 3)
        np.testing.assert_array_equal(t_out[0].numpy().view(np.uint64),
                                      np.asarray(j_out[0]))
        for a, b in zip(t_out[1:], j_out[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------ controller runs

def _records(ctl):
    return dict(stage=ctl.stage, rows_copied=ctl.rows_copied,
                dw=ctl.dw_windows,
                migrations=[{k: v for k, v in m.items() if k != "duration_s"}
                            for m in ctl.migrations],
                aborts=[dict(a) for a in ctl.aborts])


def _jax_plan(plan):
    return JR.ReshardPlan(plan.lo, plan.hi, plan.src, plan.dst, plan.kind)


class _Twin(RS.ReshardRun):
    """The port's reshard smoke run (testing/reshard_smoke.py) with the
    JAX package's oracle, router, state and controller stepped beside it
    through the same windows: each window's results, each stage's records
    and each digest equal."""

    def __init__(self, n, tmp, seed):
        super().__init__(n, "cpu", seed, flight_dir=str(tmp))
        sm = JOracle()
        sm.create_accounts([JT.Account(id=i, ledger=1, code=1)
                            for i in range(1, N_ACCTS + 1)], 50)
        self.jr = _jrouter(n)
        self.js = self.jr.from_oracle(sm)
        self.jc = JR.ReshardController(self.jr, chunk_rows=8,
                                       min_double_write_windows=2)
        self.windows = 0

    def begin(self, plan):
        super().begin(plan)
        self.js = self.jc.begin(self.js, _jax_plan(plan))
        self.check()

    def corrupt_next_chunk(self):
        super().corrupt_next_chunk()
        self.jc.corrupt_next_chunk = True

    def step(self, batches, tss):
        aborted = super().step(batches, tss)
        j_batches = [[JT.Transfer(**dataclasses.asdict(t)) for t in b]
                     for b in batches]
        arrays = [JB.transfers_to_arrays(e) for e in j_batches]
        j_aborted = None
        try:
            self.js = self.jc.on_window(self.js, arrays)
        except JR.MigrationAborted as e:
            self.js, j_aborted = e.state, e.reason
        self.js, j_res = self.jr.step_window(self.js, arrays, tss)
        for (ts_st, ts_ts), (js_st, js_ts) in zip(self.results, j_res):
            np.testing.assert_array_equal(ts_st, js_st)
            np.testing.assert_array_equal(ts_ts, js_ts)
        self.windows += 1
        self.check()
        assert aborted == j_aborted, (aborted, j_aborted)
        return aborted

    def range_digest(self, plan):
        got = super().range_digest(plan)
        assert got == JSE.partitioned_range_digest(
            self.js, plan.lo, plan.hi, plan.src)
        return got

    def check(self):
        assert _records(self.ctl) == _records(self.jc)
        assert self.router.ownership.entries == self.jr.ownership.entries
        assert self.router.host_fallbacks == self.jr.host_fallbacks == 0

    def final(self):
        got = super().final()
        assert got == JSE.partitioned_state_digest(self.js)
        _assert_states_equal(partitioned_to_numpy(self.state),
                             _jstate_np(self.js))
        return got


def mesh_run(n, tmp):
    """The port's reshard_smoke.mesh_run with the JAX package's controller
    in lockstep (the JAX package's reshard_smoke._mesh_run, same seed): a
    split, a migrate and a merge_back under live traffic."""
    tw = _Twin(n, tmp, RS.SEED + n)
    out = RS.mesh_run(tw)
    assert out["windows"] == len(tw.history) and tw.windows >= 2 + 3 * 3
    return tw


# Mesh 8's run is in tests/test_torch_resharding_mesh8.py (its JAX steps
# take ~130 s to compile: a file of its own spreads the suite's load).
def test_controller_mesh_run_equals_the_jax_packages(tmp_path):
    mesh_run(2, tmp_path)


def test_corrupted_chunk_aborts_as_the_jax_packages(tmp_path, monkeypatch):
    """reshard_smoke.negative_run with the JAX package's controller in
    lockstep (its _negative_run's seed): the corrupted chunk aborts both
    at the same window, before the flip, with an artifact; the traffic
    after it stays exact."""
    monkeypatch.setenv("TB_TPU_FLIGHT_DIR", str(tmp_path / "jax"))
    tw = _Twin(2, tmp_path, RS.SEED + 100 + 2)
    out = RS.negative_run(tw, str(tmp_path))
    assert out["abort"] == "digest_mismatch" and tw.ctl.stage == "aborted"
    assert glob.glob(str(tmp_path / "FLIGHT_*_reshard_abort_digest_*"))
    assert glob.glob(str(tmp_path / "jax" / "FLIGHT_*_reshard_*"))


@pytest.fixture()
def jax_reshard_router(monkeypatch):
    """The JAX package's cached reshard-chaos router on its default mesh
    (2 host devices), sharing this module's compiled steps."""
    r = _jrouter(2)
    monkeypatch.setattr(JCH, "_RESHARD_ROUTER", r)
    return r


@pytest.mark.parametrize("seed", [2, 10, 3])
def test_reshard_chaos_scenario_equals_the_jax_packages(
        seed, tmp_path, monkeypatch, jax_reshard_router):
    got = TCH.reshard_chaos_scenario(seed, device="cpu",
                                     flight_dir=str(tmp_path))
    want = JCH.reshard_chaos_scenario(seed)
    assert got == want
    assert got["aborts"] == got["artifacts"] == 6
    assert len(glob.glob(str(tmp_path / "FLIGHT_*_reshard_*"))) == 6
    # The cached router comes back with base ownership; a given mesh gets
    # a fresh router.
    routers = [r for k, r in TCH._RESHARD_ROUTERS.items()
               if k == ("cpu", str(tmp_path))]
    assert routers and routers[0].ownership.entries == ()
    assert TCH.reshard_chaos_scenario(seed, mesh=_tmesh(2)) == got


# ------------------------------------- the JAX tests/test_resharding.py

EDGE_IDS = [0, 1, 2, U64MAX - 1, U64MAX, U64MAX + 1, (1 << 127),
            (1 << 127) + 1, U128MAX - 1, U128MAX]


def _split(ids):
    hi = np.array([(i >> 64) & U64MAX for i in ids], dtype=np.uint64)
    lo = np.array([i & U64MAX for i in ids], dtype=np.uint64)
    return hi, lo


def _fuzz_ids(seed, n=256):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    return [int(h) << 64 | int(l) for h, l in zip(hi, lo)]


def test_shard_hash_host_device_identity():
    """The torch hash (device path), the numpy hash (the snapshot's) and
    the Python-int hash (oracle packing, range membership) agree bit for
    bit on every id, and with the JAX package's."""
    ids = EDGE_IDS + _fuzz_ids(7)
    hi, lo = _split(ids)
    h_t = TSU.mix_id(carrier(hi, "cpu"), carrier(lo, "cpu")).numpy().view(
        np.uint64)
    h_np = TSU.mix_id_np(hi, lo)
    np.testing.assert_array_equal(h_t, h_np)
    np.testing.assert_array_equal(h_np, np.asarray(jax.jit(JSU.mix_id)(hi,
                                                                       lo)))
    for i, want in zip(ids, h_np.tolist()):
        assert TSU.mix_int(i) == want, hex(i)
    for n_shards in (1, 2, 8):
        dev = TSU.shard_of_id(carrier(hi, "cpu"), carrier(lo, "cpu"),
                              n_shards).tolist()
        for i, got in zip(ids, dev):
            assert TSU.shard_of_int(i, n_shards) == got, (hex(i), n_shards)


def test_overlay_bit_identity_all_modes():
    """`owner_read` / `writes_here` on tensors against the host forms
    under three entries of the three modes, the bounds on sampled hashes
    (the inclusive edges), one range past 2^63."""
    n_shards = 8
    ids = EDGE_IDS + _fuzz_ids(11)
    hs = sorted(TSU.mix_int(i) for i in ids)
    entries = (
        (hs[5], hs[60], 0, 1, TSU.OVERLAY_DOUBLE_WRITE),
        (hs[20], hs[120], 1, 2, TSU.OVERLAY_MIGRATED),
        (hs[80], hs[240], 2, 3, TSU.OVERLAY_RETURNING),
    )
    assert hs[240] >= HALF
    hi, lo = _split(ids)
    kh, kl = carrier(hi, "cpu"), carrier(lo, "cpu")
    own = TSU.owner_read(kh, kl, n_shards, entries).tolist()
    assert own == np.asarray(JSU.owner_read(hi, lo, n_shards,
                                            entries)).tolist()
    for i, got in zip(ids, own):
        assert TSU.owner_read_int(i, n_shards, entries) == got, hex(i)
    for me in range(n_shards):
        w = TSU.writes_here(kh, kl, n_shards, me, entries).tolist()
        for i, got in zip(ids, w):
            assert got == (me in TSU.write_owners_int(i, n_shards, entries))
    for (elo, ehi, src, dst, mode) in entries:
        member = next(i for i in ids if elo <= TSU.mix_int(i) <= ehi
                      and TSU.shard_of_int(i, n_shards) == src)
        owner = TSU.owner_read_int(member, n_shards, entries)
        writers = TSU.write_owners_int(member, n_shards, entries)
        if mode == TSU.OVERLAY_DOUBLE_WRITE:
            assert owner == src and set(writers) == {src, dst}
        elif mode == TSU.OVERLAY_MIGRATED:
            assert owner == dst and writers == (dst,)
        else:
            assert owner == dst and set(writers) == {src, dst}


def test_empty_overlay_identical_lowering():
    """With no overlay `owner_read` is `shard_of_id`, and a router's
    step cache hands back the same step object for an empty overlay at any
    generation: idle windows pay nothing for being ready to reshard."""
    hi, lo = _split(EDGE_IDS + _fuzz_ids(3, 64))
    kh, kl = carrier(hi, "cpu"), carrier(lo, "cpu")
    assert torch.equal(TSU.owner_read(kh, kl, 8, ()),
                       TSU.shard_of_id(kh, kl, 8))
    r = _t_router(8)
    step, chain = r._step("plain"), r._chain_step("plain")
    r.set_ownership(TSU.OwnershipTable(8, 5, ()))
    assert r._step("plain") is step and r._chain_step("plain") is chain


def test_overlay_lowering_selects_its_own_step():
    """An overlay selects a step of its own (the cache keys on the
    entries), the same object each time it comes back, and the base step
    again when the overlay goes; the routing itself is deterministic."""
    entries = ((0, 1 << 62, 0, 1, TSU.OVERLAY_DOUBLE_WRITE),
               (HALF, U64MAX, 2, 3, TSU.OVERLAY_RETURNING))
    r = _t_router(8)
    base = r._chain_step("plain")
    r.set_ownership(TSU.OwnershipTable(8, 1, entries))
    over = r._chain_step("plain")
    assert over is not base and r._chain_step("plain") is over
    r.set_ownership(TSU.OwnershipTable(8, 2, ()))
    assert r._chain_step("plain") is base
    r.set_ownership(TSU.OwnershipTable(8, 3, entries))
    assert r._chain_step("plain") is over
    hi, lo = _split(EDGE_IDS + _fuzz_ids(3, 64))
    kh, kl = carrier(hi, "cpu"), carrier(lo, "cpu")
    a = (TSU.owner_read(kh, kl, 8, entries),
         TSU.writes_here(kh, kl, 8, 3, entries))
    b = (TSU.owner_read(kh, kl, 8, entries),
         TSU.writes_here(kh, kl, 8, 3, entries))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_ownership_table_generations_and_validation():
    t0 = TSU.OwnershipTable(4)
    assert not t0.active and t0.generation == 0
    t1 = t0.with_entry(0, 1 << 32, 1, 2, TSU.OVERLAY_DOUBLE_WRITE)
    assert t1.active and t1.generation == 1
    t2 = t1.transition(t1.entries[0], TSU.OVERLAY_MIGRATED)
    assert t2.generation == 2 and t2.entries[0][4] == TSU.OVERLAY_MIGRATED
    t3 = t2.without_entry(t2.entries[0])
    assert t3.generation == 3 and not t3.active
    with pytest.raises(AssertionError):   # src == dst
        t0.with_entry(0, 10, 1, 1, TSU.OVERLAY_DOUBLE_WRITE)
    with pytest.raises(AssertionError):   # a bad mode
        t0.with_entry(0, 10, 1, 2, 9)
    with pytest.raises(AssertionError):   # lo > hi
        t0.with_entry(10, 0, 1, 2, TSU.OVERLAY_DOUBLE_WRITE)
    with pytest.raises(AssertionError):   # overlap from one source
        t1.with_entry(1 << 32, 1 << 33, 1, 3, TSU.OVERLAY_MIGRATED)
    t1.with_entry(0, 1 << 32, 2, 3, TSU.OVERLAY_MIGRATED)
    with pytest.raises(AssertionError):   # a mesh not a power of two
        TSU.OwnershipTable(3)


def test_reshard_plan_validation_and_membership():
    for bad in (dict(lo=10, hi=0, src=0, dst=1),
                dict(lo=0, hi=10, src=1, dst=1),
                dict(lo=0, hi=10, src=0, dst=1, kind="shuffle")):
        with pytest.raises(AssertionError):
            TR.ReshardPlan(**bad)
    for mid in (HALF, HALF + (1 << 62)):
        plan = TR.ReshardPlan(lo=0, hi=mid, src=0, dst=1)
        jplan = JR.ReshardPlan(lo=0, hi=mid, src=0, dst=1)
        for i in EDGE_IDS + _fuzz_ids(5, 64):
            h = TSU.mix_int(i)
            want = h <= mid and (h & 7) == 0
            assert plan.in_range(i, 8) == want == jplan.in_range(i, 8)


def _soa(ids):
    hi, lo = _split(ids)
    z = np.zeros(len(ids), dtype=np.uint64)
    return {"id_hi": hi, "id_lo": lo, "pid_hi": z, "pid_lo": z,
            "dr_hi": z, "dr_lo": z, "cr_hi": z, "cr_lo": z}


def test_conflicts_hashes_ids_in_both_batch_forms():
    """`conflicts` freezes the copy stage's range against SoA ev dicts and
    Transfer objects alike, hashing the raw ids (never taking an id as its
    hash), with the JAX package's verdict on each probe."""
    ctls = [TR.ReshardController(SimpleNamespace(n_shards=2)),
            JR.ReshardController(SimpleNamespace(n_shards=2))]
    a = next(i for i in _fuzz_ids(17) if TSU.mix_int(i) >= HALF)
    h = TSU.mix_int(a)
    src = h & 1
    out = next(i for i in _fuzz_ids(19) if TSU.mix_int(i) != h)

    def verdict(batches):
        got = [c.conflicts(batches) for c in ctls]
        assert got[0] == got[1], batches
        return got[0]

    def set_plan(lo, hi):
        for c, R in zip(ctls, (TR, JR)):
            c.stage = "copy"
            c.plan = R.ReshardPlan(lo=lo, hi=hi, src=src, dst=1 - src)

    def obj(i, field="id"):
        kw = dict(id=out, pending_id=0, debit_account_id=0,
                  credit_account_id=0)
        kw[field] = i
        return SimpleNamespace(**kw)

    set_plan(h, h)
    assert verdict([_soa([a])])
    for k in ("pid", "dr", "cr"):
        d = dict(_soa([0]))
        d[f"{k}_hi"], d[f"{k}_lo"] = _split([a])
        assert verdict([d]), k
    assert not verdict([_soa([0])]) and not verdict([_soa([out])])
    for field in ("id", "pending_id", "debit_account_id",
                  "credit_account_id"):
        assert verdict([[obj(a, field)]]), field
    assert not verdict([[obj(out)]])
    if TSU.mix_int(h) != h:
        assert not verdict([[obj(h)]])
    set_plan(0, h)
    assert verdict([_soa([a])])
    set_plan(h, U64MAX)
    assert verdict([_soa([a])])
    set_plan(h + 1, U64MAX)
    assert not verdict([_soa([a])])
    set_plan(h, h)
    for stage in ("idle", "double_write", "flip", "done"):
        for c in ctls:
            c.stage = stage
        assert not verdict([_soa([a])]), stage
    for c in ctls:
        c.stage = "copy"
    assert not verdict([])


def _acct_window(accounts, n_events):
    ids = [accounts[i % len(accounts)] for i in range(n_events)]
    hi, lo = _split(ids)
    z = np.zeros(n_events, dtype=np.uint64)
    return {"dr_hi": hi, "dr_lo": lo, "cr_hi": z, "cr_lo": z}


def _accounts_on_shard(shard, n_shards, k, start=1):
    out, i = [], start
    while len(out) < k:
        if TSU.shard_of_int(i, n_shards) == shard:
            out.append(i)
        i += 1
    return out


def _detectors(**kw):
    return TR.HotRangeDetector(**kw), JR.HotRangeDetector(**kw)


def _propose(dets):
    got = [d.propose() for d in dets]
    if got[0] is not None and "plan" in got[0]:
        p, q = got[0]["plan"], got[1]["plan"]
        assert (p.lo, p.hi, p.src, p.dst, p.kind) == \
            (q.lo, q.hi, q.src, q.dst, q.kind)
        got = [{k: v for k, v in g.items() if k != "plan"} for g in got]
        got[0]["plan"] = p
    else:
        assert got[0] == got[1]
    return got[0]


def test_hot_range_detector_verdicts():
    dets = _detectors(n_shards=2)
    for d in dets:
        d.observe_window([_acct_window([1], 16)])
    assert _propose(dets) is None
    a0 = _accounts_on_shard(0, 2, 4)
    a1 = _accounts_on_shard(1, 2, 4)
    dets = _detectors(n_shards=2)
    for d in dets:
        d.observe_window([_acct_window(a0 + a1, 128)])
    assert _propose(dets) is None
    dets = _detectors(n_shards=2)
    for d in dets:
        d.observe_window([_acct_window(a0, 128)])
    v = _propose(dets)
    assert v is not None and v["verdict"] == "split", v
    plan = v["plan"]
    assert (plan.kind, plan.src, plan.dst, plan.lo) == ("split", 0, 1, 0)
    assert any(plan.in_range(i, 2) for i in a0)
    assert not all(plan.in_range(i, 2) for i in a0)
    assert _propose(dets) is None   # the cooldown


def test_hot_range_detector_unsplittable_single_account():
    dets = _detectors(n_shards=2)
    for d in dets:
        d.observe_window([_acct_window([7], 128)])
    v = _propose(dets)
    assert v is not None and v["verdict"] == "unsplittable", v
    assert v["shard"] == TSU.shard_of_int(7, 2)
    assert v["hot_hash"] == TSU.mix_int(7) and v["fraction"] == 1.0
    assert "AT2" in v["note"]
    assert _propose(dets) is None
    for d in dets:
        d.observe_window([_acct_window([7], 128)])
    assert _propose(dets) is None


def test_hot_range_detector_object_batches():
    dets = _detectors(n_shards=2)
    batch = [SimpleNamespace(debit_account_id=7, credit_account_id=0)
             for _ in range(128)]
    for d in dets:
        d.observe_window([batch])
    v = _propose(dets)
    assert v is not None and v["verdict"] == "unsplittable"
    assert v["shard"] == TSU.shard_of_int(7, 2)


def test_resharding_refuses_a_multi_process_mesh():
    mesh = TSU.Mesh(["cpu"] * 2, process_count=2, process_index=0)
    ctl = TR.ReshardController(SimpleNamespace(
        mesh=mesh, n_shards=4, tracer=None))
    with pytest.raises(ValueError, match="one process"):
        ctl.begin((), TR.ReshardPlan(lo=0, hi=1, src=0, dst=1))
