"""Port parity: the replicated-state mesh route, on the CPU.

- `parallel/shard_utils.py`: the ownership hash, the shard of an id and
  the overlay's read and write owners equal the JAX package's for 10,000
  seeded ids (top-bit ids among them), on the device forms and the host
  forms; the ownership table's transitions.
- The in-process mesh: `default_mesh`, `replicate`, `all_gather`,
  `shard_batch`.
- The sharded step on 8 logical CPU shards, for the four modes, against
  the JAX package's single-chip `create_transfers_fast` under its
  `full_sharded._MODE_KWARGS` (the JAX router's `_single_step`), from the
  same pre-state: statuses, timestamps, the fallback and cause flags,
  created counts, every live row of the state and both hash tables, and
  the state digest. The imported mode holds commit_ts to the port's
  single-chip tier instead (the JAX package's imported tiers leave it at
  the prepare timestamp; the port keeps the oracle's).
- The 2-shard plain step against the JAX package's own sharded step on a
  2-device mesh (`Mesh(jax.devices()[:2])`).
- `ShardedRouter`: a run of batches through the port's router on 8
  shards and through the JAX package's router, whose sharded and
  single-chip steps are its jitted single-chip tiers (bit-identical to
  its sharded steps, above): every step's results and the final stats
  equal — escalations, fallbacks by cause, reroutes.
- `shard_loss_scenario(seed, mesh=...)` on 2 shards equal to the JAX
  package's on a 2-device mesh, the dropped device's name aside.

Inputs are made with numpy from a seed; the kernels run at one pad
bucket (128, 16 lanes a shard on 8 shards), so each JAX tier compiles
once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.ops import batch as JB
from tigerbeetle_tpu.ops import fast_kernels as JFK
from tigerbeetle_tpu.ops import ledger as JL
from tigerbeetle_tpu.ops.state_epoch import device_state_digest as jax_digest
from tigerbeetle_tpu.parallel import full_sharded as JFS
from tigerbeetle_tpu.parallel import shard_utils as JSU
from tigerbeetle_tpu.testing import chaos as JCH
from tigerbeetle_tpu.types import Account, Transfer
from tigerbeetle_tpu.types import AccountFlags as AF
from tigerbeetle_tpu.types import TransferFlags as TF
from tigerbeetle_tpu_torch.convert import state_from_numpy, state_to_numpy
from tigerbeetle_tpu_torch.ops import fast_kernels as TFK
from tigerbeetle_tpu_torch.ops import fused_probe, row_gather
from tigerbeetle_tpu_torch.ops.ledger import events_to_device
from tigerbeetle_tpu_torch.ops.state_epoch import device_state_digest
from tigerbeetle_tpu_torch.ops.u64 import carrier
from tigerbeetle_tpu_torch.parallel import full_sharded as TFS
from tigerbeetle_tpu_torch.parallel import shard_utils as TSU
from tigerbeetle_tpu_torch.testing import chaos as TCH
from tests.port_verify import (port_verify_off,  # noqa: F401
                               port_verify_restored)

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

A_CAP = 256
T_CAP = 2048
N_PAD = 128
TS0 = 10 ** 9
U128_MAX = (1 << 128) - 1
PEND, POST, VOID = (int(TF.pending), int(TF.post_pending_transfer),
                    int(TF.void_pending_transfer))
IMP, BAL_DR, CLOSE_DR = (int(TF.imported), int(TF.balancing_debit),
                         int(TF.closing_debit))
MODES = ("plain", "fixpoint", "balancing", "imported")
OUT_KEYS = ("fallback", "limit_only", "limit_hit", "fix_unconverged",
            "fix_rounds", "created_count")
MESH8 = TSU.Mesh(["cpu"] * 8)

# The JAX package's single-chip tiers under the sharded modes' kwargs
# (its router's _single_step, without the buffer donation).
JIT = {mode: jax.jit(functools.partial(JFK.create_transfers_fast,
                                       **JFS._MODE_KWARGS[mode]))
       for mode in MODES}
_jit_accounts = jax.jit(JFK.create_accounts_fast)


@pytest.fixture(autouse=True)
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_states_equal(got: dict, want: dict, commit: bool = True):
    """Port state (numpy view) vs JAX state, dump row/bucket excepted."""
    for store in ("accounts", "transfers", "events"):
        for k, w in want[store].items():
            g = got[store][k]
            if k == "count":
                assert int(g) == int(w), (store, k)
            else:
                np.testing.assert_array_equal(g[:-1], w[:-1],
                                              err_msg=f"{store}.{k}")
    for table in ("acct_ht", "xfer_ht"):
        np.testing.assert_array_equal(got[table]["packed"][:-1],
                                      want[table]["packed"][:-1],
                                      err_msg=table)
    for k in ("acct_key_max", "xfer_key_max", "pulse_next") + (
            ("commit_ts",) if commit else ()):
        assert int(got[k]) == int(want[k]), k


def _assert_outs_equal(t_out, j_out, tag):
    np.testing.assert_array_equal(t_out["r_status"].numpy(),
                                  j_out["r_status"].astype(np.int64),
                                  err_msg=tag)
    np.testing.assert_array_equal(t_out["r_ts"].numpy().view(np.uint64),
                                  j_out["r_ts"], err_msg=tag)
    for k in OUT_KEYS:
        if k in j_out:
            assert int(t_out[k]) == int(j_out[k]), (tag, k)
    assert ({k: bool(v) for k, v in t_out["fb_causes"].items()}
            == {k: bool(v) for k, v in j_out["fb_causes"].items()}), tag


def _xfer(id_, dr, cr, amt, flags=0, pid=0, ts=0):
    return Transfer(id=id_, debit_account_id=dr, credit_account_id=cr,
                    amount=amt, ledger=1, code=1, flags=flags,
                    pending_id=pid, timestamp=ts)


@functools.lru_cache(maxsize=1)
def _pre_state():
    """The JAX package's ledger after the setup: accounts 1-8 plain, 9
    and 10 debit-limited, 11 and 12 plain (closing targets), 9 and 10
    funded with 100 each, and a committed pending (id 5000). Host
    numpy, the JAX layout."""
    js = JL.init_state(A_CAP, T_CAP)
    accts = ([Account(id=i, ledger=1, code=1) for i in range(1, 9)]
             + [Account(id=i, ledger=1, code=1,
                        flags=int(AF.debits_must_not_exceed_credits))
                for i in (9, 10)]
             + [Account(id=i, ledger=1, code=1) for i in (11, 12)])
    ev = JL.pad_account_events(JB.accounts_to_arrays(accts), N_PAD)
    js, out = _jit_accounts(js, ev, np.uint64(1_000), np.int32(len(accts)))
    assert not bool(out["fallback"])
    setup = [_xfer(4000, 1, 9, 100), _xfer(4001, 1, 10, 100),
             _xfer(5000, 2, 3, 50, flags=PEND)]
    ev = JL.pad_transfer_events(JB.transfers_to_arrays(setup), N_PAD)
    js, out = JIT["plain"](js, ev, np.uint64(TS0), np.int32(len(setup)))
    assert not bool(out["fallback"])
    return _np(js)


def _batch(mode: str, seed: int) -> list:
    """One batch of `mode`'s traffic, seeded: uniform transfers over
    accounts 1-8 (1 in 4 pending, failing lanes: an unknown account, a
    ledger mismatch), plus the mode's own lanes spread over the shards."""
    rng = np.random.default_rng(seed)
    n = 100
    out = []
    for i in range(n):
        dr, cr = (int(x) for x in rng.choice(np.arange(1, 9), 2,
                                             replace=False))
        flags = PEND if rng.random() < 0.25 else 0
        out.append(_xfer(10_000 + i, dr, cr, int(rng.integers(1, 99)),
                         flags=flags))
    out[7] = _xfer(10_007, 1, 77, 5)                     # unknown account
    out[23] = Transfer(id=10_023, debit_account_id=1, credit_account_id=2,
                       amount=5, ledger=2, code=1)       # ledger mismatch
    out[41] = _xfer(10_041, 0, 0, U128_MAX, flags=POST, pid=5000)
    if mode == "fixpoint":
        # A limit cascade on account 9 (funded 100) across shards, an
        # in-batch pending posted and another voided in a later shard
        # (the spmd join), a closing pending.
        for j, lane in enumerate((3, 19, 35, 51, 67, 83)):
            out[lane] = _xfer(11_000 + j, 9, 4, 30)
        out[5] = _xfer(12_000, 1, 2, 40, flags=PEND)
        out[70] = _xfer(12_001, 0, 0, U128_MAX, flags=POST, pid=12_000)
        out[20] = _xfer(12_002, 3, 4, 7, flags=PEND)
        out[99] = _xfer(12_003, 0, 0, 0, flags=VOID, pid=12_002)
        out[60] = _xfer(12_004, 11, 5, 1, flags=PEND | CLOSE_DR)
    elif mode == "balancing":
        for j, lane in enumerate((9, 30, 58, 91)):
            out[lane] = _xfer(13_000 + j, 9 + j % 2, 6, 1_000,
                              flags=BAL_DR)
    elif mode == "imported":
        # A whole imported batch: increasing user timestamps between the
        # accounts' and the prepare's, one regress lane.
        base = TS0 + 1_000
        out = [_xfer(14_000 + i, e.debit_account_id, e.credit_account_id,
                     e.amount, flags=IMP, ts=base + 3 * i)
               for i, e in enumerate(out)
               if e.ledger == 1 and e.pending_id == 0
               and e.debit_account_id != 0]
        out[50] = _xfer(14_999, 1, 2, 5, flags=IMP, ts=base + 3 * 10)
    return out


def _padded(events):
    return JL.pad_transfer_events(JB.transfers_to_arrays(events), N_PAD)


# ------------------------------------------------------------ shard_utils

def _seeded_ids(n=10_000, seed=11):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2 ** 64, n, dtype=np.uint64)
    lo = rng.integers(0, 2 ** 64, n, dtype=np.uint64)
    hi[: n // 4] = 0                                     # plain ids
    hi[n // 4: n // 2] |= np.uint64(1 << 63)             # top bit set
    lo[n // 2: n // 2 + 64] = np.uint64((1 << 64) - 1)
    return hi, lo


OVERLAYS = [
    (),
    ((0, (1 << 63) - 1, 0, 1, JSU.OVERLAY_MIGRATED),),
    ((1 << 62, (1 << 64) - 1, 1, 3, JSU.OVERLAY_DOUBLE_WRITE),
     (0, 1 << 60, 2, 0, JSU.OVERLAY_MIGRATED),
     (1 << 63, (1 << 64) - 1, 3, 2, JSU.OVERLAY_RETURNING)),
]


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_ownership_hash_and_shard_equal_the_jax_packages(n_shards):
    hi, lo = _seeded_ids()
    t_hi, t_lo = carrier(hi, "cpu"), carrier(lo, "cpu")
    np.testing.assert_array_equal(
        TSU.mix_id(t_hi, t_lo).numpy().view(np.uint64),
        JSU.mix_id(hi, lo))
    np.testing.assert_array_equal(
        TSU.shard_of_id(t_hi, t_lo, n_shards).numpy(),
        JSU.shard_of_id(hi, lo, n_shards))
    for h, l in zip(hi[::97].tolist(), lo[::97].tolist()):
        id128 = (int(h) << 64) | int(l)
        assert TSU.mix_int(id128) == JSU.mix_int(id128)
        assert (TSU.shard_of_int(id128, n_shards)
                == JSU.shard_of_int(id128, n_shards)
                == int(JSU.shard_of_id(np.array([h], np.uint64),
                                       np.array([l], np.uint64),
                                       n_shards)[0]))


@pytest.mark.parametrize("overlay", range(len(OVERLAYS)))
def test_overlay_owners_equal_the_jax_packages(overlay):
    entries = OVERLAYS[overlay]
    n_shards = 4
    hi, lo = _seeded_ids(seed=12)
    t_hi, t_lo = carrier(hi, "cpu"), carrier(lo, "cpu")
    np.testing.assert_array_equal(
        TSU.owner_read(t_hi, t_lo, n_shards, entries).numpy(),
        np.asarray(JSU.owner_read(hi, lo, n_shards, entries)))
    for me in range(n_shards):
        np.testing.assert_array_equal(
            TSU.writes_here(t_hi, t_lo, n_shards, me, entries).numpy(),
            np.asarray(JSU.writes_here(hi, lo, n_shards, me, entries)))
    for h, l in zip(hi[::53].tolist(), lo[::53].tolist()):
        id128 = (int(h) << 64) | int(l)
        assert (TSU.owner_read_int(id128, n_shards, entries)
                == JSU.owner_read_int(id128, n_shards, entries))
        assert (TSU.write_owners_int(id128, n_shards, entries)
                == JSU.write_owners_int(id128, n_shards, entries))


def test_ownership_table_transitions_equal_the_jax_packages():
    tables = []
    for mod in (TSU, JSU):
        t = mod.OwnershipTable(4)
        e = (0, 1 << 62, 1, 2, mod.OVERLAY_DOUBLE_WRITE)
        t = t.with_entry(*e)
        t = t.transition(e, mod.OVERLAY_MIGRATED)
        t = t.with_entry(1 << 63, (1 << 64) - 1, 3, 0,
                         mod.OVERLAY_RETURNING)
        ids = [(7 << 64) | 9, 1 << 127, 12345, (1 << 128) - 2]
        tables.append((t.generation, t.entries, t.active,
                       [t.owner_read_int(i) for i in ids],
                       [t.write_owners_int(i) for i in ids],
                       t.without_entry(e).entries))
        with pytest.raises(AssertionError):
            mod.OwnershipTable(4, entries=((0, 5, 1, 2, 2), (3, 9, 1, 3, 2)))
    assert tables[0] == tables[1]


# ----------------------------------------------------------------- mesh

def test_mesh_replicate_gather_and_shard_batch():
    mesh = TSU.default_mesh("cpu")
    assert mesh.size == 8 and mesh.shape == {"batch": 8}
    assert mesh.distinct == (torch.device("cpu"),)
    state = state_from_numpy(_pre_state(), "cpu")
    (rep,) = TSU.replicate(mesh, state)
    assert rep is state                    # held once, not copied
    ev = _padded(_batch("plain", 1))
    shards = TFS.shard_batch(mesh, ev)
    assert len(shards) == 8 and all(s["id_lo"].shape == (16,)
                                    for s in shards)
    (full,) = TSU.all_gather(mesh, shards)
    for k, v in events_to_device(ev, "cpu").items():
        assert torch.equal(full[k], v), k
    with pytest.raises(ValueError):
        TFS.shard_batch(TSU.Mesh(["cpu"] * 3), ev)
    with pytest.raises(ValueError):
        TSU.all_gather(mesh, shards[:7])


# --------------------------------------------------- the sharded step

@pytest.mark.parametrize("mode", MODES)
def test_sharded_step_equals_the_jax_single_chip_tier(mode):
    pre = _pre_state()
    events = _batch(mode, seed=MODES.index(mode) + 1)
    n = len(events)
    ts = TS0 + 10 ** 6
    ev = _padded(events)
    j_state, j_out = JIT[mode](_jnp(pre), ev, np.uint64(ts), np.int32(n))
    j_out = _np(j_out)
    state = TSU.replicate(MESH8, state_from_numpy(pre, "cpu"))
    step = TFS.make_sharded_create_transfers(MESH8, mode=mode)
    state, t_out = step(state, TFS.shard_batch(MESH8, ev), ts, n)
    _assert_outs_equal(t_out, j_out, mode)
    assert not bool(j_out["fallback"]), j_out["fb_causes"]
    assert int(j_out["created_count"]) > 0
    imported = mode == "imported"
    _assert_states_equal(state_to_numpy(state[0]), _np(j_state),
                         commit=not imported)
    # The port's single-chip tier from the same pre-state: the same
    # state to the bit (commit_ts included) and the same digest.
    s1, o1 = TFK.create_transfers_fast(state_from_numpy(pre, "cpu"),
                                       events_to_device(ev, "cpu"), ts, n,
                                       **TFS._MODE_KWARGS[mode])
    assert torch.equal(o1["r_status"], t_out["r_status"])
    digest = device_state_digest(state[0])
    assert digest == device_state_digest(s1)
    want = _np(j_state)
    if imported:
        want["commit_ts"] = np.uint64(int(state[0]["commit_ts"]) & (2**64 - 1))
    assert digest == {k: int(v) for k, v in jax_digest(_jnp(want)).items()}


def test_fixpoint_batch_runs_the_spmd_join():
    """The fixpoint batch's posted and voided in-batch pendings are
    substituted on the sharded tail: their definitions and uses sit in
    different shards, and both resolve as the single-chip tier's."""
    events = _batch("fixpoint", seed=2)
    ev = _padded(events)
    state = TSU.replicate(MESH8, state_from_numpy(_pre_state(), "cpu"))
    state, out = TFS.make_sharded_create_transfers(MESH8, mode="fixpoint")(
        state, TFS.shard_batch(MESH8, ev), TS0 + 10 ** 6, len(events))
    created = 0xFFFFFFFF
    st = out["r_status"].tolist()
    assert st[5] == st[70] == st[20] == st[99] == created
    assert 5 // 16 != 70 // 16 and 20 // 16 != 99 // 16


def test_two_shard_plain_step_equals_the_jax_sharded_step():
    pre = _pre_state()
    events = _batch("plain", seed=5)
    n, ts = len(events), TS0 + 10 ** 6
    ev = _padded(events)
    jmesh = JMesh(np.array(jax.devices()[:2]), ("batch",))
    jstep = JFS.make_sharded_create_transfers(jmesh, mode="plain")
    j_state, j_out = jstep(_jnp(pre), JFS.shard_batch(jmesh, ev),
                           np.uint64(ts), np.int32(n))
    mesh = TSU.Mesh(["cpu"] * 2)
    state = TSU.replicate(mesh, state_from_numpy(pre, "cpu"))
    state, t_out = TFS.make_sharded_create_transfers(mesh, mode="plain")(
        state, TFS.shard_batch(mesh, ev), ts, n)
    _assert_outs_equal(t_out, _np(j_out), "sharded plain")
    _assert_states_equal(state_to_numpy(state[0]), _np(j_state))
    assert device_state_digest(state[0]) == {
        k: int(v) for k, v in jax_digest(j_state).items()}


@pytest.mark.parametrize("mode", MODES)
def test_sharded_step_kernel_calls(mode, port_verify_off):
    """Each shard's per-event stage makes one probe and two row gathers;
    the tail makes the single-chip tier's row gathers and no probe (the
    wrappers' calls, counted through their cost hook: on the card each
    is one launch)."""
    kind = {"plain": 4, "fixpoint": 5, "balancing": 5, "imported": 4}

    class Calls:
        def __init__(self):
            self.n = {}

        def kernel(self, name, fn, _bound, *args):
            self.n[name] = self.n.get(name, 0) + 1
            return fn(*args)

    events = _batch(mode, seed=3)
    ev = _padded(events)
    for shards in (1, 2, 8):
        mesh = TSU.Mesh(["cpu"] * shards)
        calls = Calls()
        state = TSU.replicate(mesh, state_from_numpy(_pre_state(), "cpu"))
        fused_probe.COST = row_gather.COST = calls
        try:
            TFS.make_sharded_create_transfers(mesh, mode=mode)(
                state, TFS.shard_batch(mesh, ev), TS0 + 10 ** 6,
                len(events))
        finally:
            fused_probe.COST = row_gather.COST = None
        assert calls.n == {"ht_probe": shards,
                           "row_gather": 2 * shards + kind[mode]}, calls.n


# ------------------------------------------------------------- router

def _router_batches():
    """(events, timestamp) a step: clean plain, a limit breach without
    flags (plain escalates to fixpoint), balancing, imported, closing,
    a repeated id (escalates, then falls back: a real duplicate), and a
    plain batch for each of the degraded and restored steps."""
    rng = np.random.default_rng(21)
    nid = [20_000]

    def plain(k):
        out = []
        for _ in range(k):
            dr, cr = (int(x) for x in rng.choice(np.arange(1, 9), 2,
                                                 replace=False))
            out.append(_xfer(nid[0], dr, cr, int(rng.integers(1, 50))))
            nid[0] += 1
        return out

    b = [plain(40)]
    b.append(plain(10) + [_xfer(30_000 + j, 10, 4, 45) for j in range(4)]
             + plain(10))
    b.append(plain(12) + [_xfer(31_000, 9, 5, 500, flags=BAL_DR)])
    b.append([_xfer(32_000 + i, 1 + i % 8, 1 + (i + 1) % 8, 3, flags=IMP,
                    ts=TS0 + 5 * 10 ** 6 + i) for i in range(20)])
    b.append(plain(8) + [_xfer(33_000, 12, 6, 1, flags=PEND | CLOSE_DR)])
    dup = plain(12)
    b.append(dup + [_xfer(dup[3].id, 1, 2, 3)])
    b.append(plain(16))
    b.append(plain(16))
    return [(evs, TS0 + (k + 1) * 10 ** 7) for k, evs in enumerate(b)]


def test_router_counters_equal_the_jax_packages():
    pre = _pre_state()
    jrouter = JFS.ShardedRouter(JMesh(np.array(jax.devices()[:2]),
                                      ("batch",)))
    jrouter._steps = dict(JIT)
    jrouter._single_steps = dict(JIT)
    trouter = TFS.ShardedRouter(MESH8)
    j_state = _jnp(pre)
    t_state = TSU.replicate(MESH8, state_from_numpy(pre, "cpu"))
    batches = _router_batches()
    for k, (events, ts) in enumerate(batches):
        if k == len(batches) - 2:
            jrouter.drop_device(jax.devices()[1])
            trouter.drop_device(MESH8.devices[3])
        if k == len(batches) - 1:
            jrouter.restore_devices()
            trouter.restore_devices()
        ev = _padded(events)
        n = len(events)
        assert TFS.ShardedRouter.route(ev) == JFS.ShardedRouter.route(ev)
        j_state, j_out, j_fell = jrouter.step(j_state, ev, ts, n)
        t_state, t_out, t_fell = trouter.step(
            t_state, TFS.shard_batch(MESH8, ev), ts, n)
        assert t_fell == j_fell, k
        _assert_outs_equal(t_out, _np(j_out), f"step {k}")
    assert trouter.stats() == jrouter.stats()
    stats = trouter.stats()
    assert stats["escalations"] >= 2 and stats["host_fallbacks"] == 1
    assert stats["shard_loss_reroutes"] == 1
    _assert_states_equal(state_to_numpy(t_state[0]), _np(j_state),
                         commit=False)


def test_shard_loss_scenario_equals_the_jax_packages():
    got = TCH.shard_loss_scenario(2, mesh=TSU.Mesh(["cpu"] * 2))
    want = JCH.shard_loss_scenario(
        2, mesh=JMesh(np.array(jax.devices()[:2]), ("batch",)))
    assert got.pop("dropped") == "cpu"
    assert want.pop("dropped").startswith("TFRT_CPU")
    assert got == want == {"devices": 2, "reroutes": 2}
