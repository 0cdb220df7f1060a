"""Port parity: the two-choice hash table and the fused probe.

The port's `ops/hash_table.py` and its probe wrapper
`ops/fused_probe.py::ht_lookup_fused` against the JAX package's, on the
same keys made from a numpy seed. The JAX fused probe runs in Pallas
interpret mode, as tests/test_pallas_kernels.py runs it. Every
comparison is exact. Tables are compared without the dump bucket, whose
contents (masked scatter lanes) are not fixed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.ops import hash_table as JHT
from tigerbeetle_tpu.ops.pallas_kernels import \
    ht_lookup_fused as jax_ht_lookup_fused
from tigerbeetle_tpu_torch.ops import fused_probe
from tigerbeetle_tpu_torch.ops import hash_table as THT

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

EDGES = [0, 1, 2**63 - 1, 2**63, 2**64 - 1]


@pytest.fixture(autouse=True)
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.uint64).view(np.int64))


def _unique_keys(rng, n):
    k_hi = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    k_lo = rng.integers(1, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    seen = set()
    for i in range(n):
        while (int(k_hi[i]), int(k_lo[i])) in seen:
            k_lo[i] += np.uint64(1)
        seen.add((int(k_hi[i]), int(k_lo[i])))
    return k_hi, k_lo


def _edge_keys():
    """Every (hi, lo) pair of bit-edge values except the empty key."""
    pairs = [(h, l) for h in EDGES for l in EDGES if (h, l) != (0, 0)]
    return (np.array([p[0] for p in pairs], dtype=np.uint64),
            np.array([p[1] for p in pairs], dtype=np.uint64))


def _filled(cap=1 << 10, n_batches=3, batch=96, seed=3):
    """The same insert sequence through both packages: random keys,
    bit-edge keys, and orphan values (ORPHAN_VAL) on some lanes; some
    lanes masked off. Returns both tables and the inserted items."""
    rng = np.random.default_rng(seed)
    jt = JHT.ht_init(cap)
    tt = THT.ht_init(cap, device="cpu")
    e_hi, e_lo = _edge_keys()
    items = {}
    for b in range(n_batches):
        k_hi, k_lo = _unique_keys(rng, batch)
        if b == 0:
            k_hi[:len(e_hi)], k_lo[:len(e_lo)] = e_hi, e_lo
        k_lo += np.uint64(b) << np.uint64(56)  # disjoint across batches
        vals = rng.integers(0, 1 << 20, batch).astype(np.int32)
        vals[rng.random(batch) < 0.2] = JHT.ORPHAN_VAL
        mask = rng.random(batch) < 0.9
        jt, j_ok = JHT.ht_insert(jt, jnp.asarray(k_hi), jnp.asarray(k_lo),
                                 jnp.asarray(vals), jnp.asarray(mask))
        tt, t_ok = THT.ht_insert(tt, _t(k_hi), _t(k_lo),
                                 torch.from_numpy(vals),
                                 torch.from_numpy(mask))
        assert bool(j_ok) and bool(t_ok)
        for i in np.flatnonzero(mask):
            items[(int(k_hi[i]), int(k_lo[i]))] = int(vals[i])
    return jt, tt, items


def _queries(items, rng, n_absent=120):
    keys = list(items)
    q_hi = [k[0] for k in keys] + [0, 0, 0]
    q_lo = [k[1] for k in keys] + [0, 0, 0]
    a_hi, a_lo = _unique_keys(rng, n_absent)
    return (np.concatenate([np.array(q_hi, dtype=np.uint64), a_hi]),
            np.concatenate([np.array(q_lo, dtype=np.uint64), a_lo]))


def test_buckets_match_jax_on_bit_edge_keys():
    e_hi, e_lo = _edge_keys()
    rng = np.random.default_rng(1)
    r_hi, r_lo = _unique_keys(rng, 200)
    k_hi = np.concatenate([e_hi, r_hi])
    k_lo = np.concatenate([e_lo, r_lo])
    for b in (2, 1 << 7, 1 << 15, 1 << 20):
        want = JHT._buckets(jnp.asarray(k_hi), jnp.asarray(k_lo), b)
        got = THT._buckets(_t(k_hi), _t(k_lo), b)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_insert_sequence_is_byte_identical_without_dump_bucket():
    jt, tt, _ = _filled()
    want = np.asarray(jt["packed"])[:-1]
    got = tt["packed"][:-1].numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)


def test_plan_matches_jax_under_contention():
    # A tiny table forces round-2 retries and an overflowing batch.
    rng = np.random.default_rng(11)
    for cap, n in ((64, 40), (64, 80)):
        k_hi, k_lo = _unique_keys(rng, n)
        mask = rng.random(n) < 0.95
        jt = JHT.ht_init(cap)
        tt = THT.ht_init(cap, device="cpu")
        j_pos, j_ok = JHT.ht_plan(jt, jnp.asarray(k_hi), jnp.asarray(k_lo),
                                  jnp.asarray(mask))
        t_pos, t_ok = THT.ht_plan(tt, _t(k_hi), _t(k_lo),
                                  torch.from_numpy(mask))
        np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))
        assert bool(t_ok) == bool(j_ok)


def test_rank_within_matches_jax():
    rng = np.random.default_rng(12)
    bucket = rng.integers(0, 9, 100)
    active = rng.random(100) < 0.7
    want = JHT._rank_within(jnp.asarray(bucket.astype(np.int32)),
                            jnp.asarray(active), 100)
    got = THT._rank_within(torch.from_numpy(bucket), torch.from_numpy(active),
                           100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lookup_agrees_on_present_absent_zero_and_orphan_keys():
    jt, tt, items = _filled()
    q_hi, q_lo = _queries(items, np.random.default_rng(4))
    want_f, want_v = JHT.ht_lookup(jt, jnp.asarray(q_hi), jnp.asarray(q_lo))
    got_f, got_v = THT.ht_lookup(tt, _t(q_hi), _t(q_lo))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.dtype == torch.int32
    # Semantics: live keys find their value, orphans surface as -1, the
    # zero key and absent keys miss.
    n_items = len(items)
    vals = np.array(list(items.values()))
    assert got_f[:n_items].all()
    np.testing.assert_array_equal(got_v[:n_items].numpy(),
                                  np.where(vals >= 0, vals, -1))
    assert not got_f[n_items:].any()


def test_fused_probe_cpu_path_matches_jax_pallas_interpret():
    jt, tt, items = _filled(seed=5)
    q_hi, q_lo = _queries(items, np.random.default_rng(6))
    want_f, want_v = jax_ht_lookup_fused(jt, jnp.asarray(q_hi),
                                         jnp.asarray(q_lo), interpret=True)
    before = fused_probe.LAUNCHES
    got_f, got_v = fused_probe.ht_lookup_fused(tt, _t(q_hi), _t(q_lo))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # The plain twin ran: no kernel launch is counted on the CPU.
    assert fused_probe.LAUNCHES == before


def test_fused_probe_refuses_tensors_off_cpu_and_cuda():
    tt = THT.ht_init(64, device="meta")
    k = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        fused_probe.ht_lookup_fused(tt, k, k)
    # Mixed devices are refused too.
    with pytest.raises(ValueError):
        fused_probe.ht_lookup_fused(THT.ht_init(64, device="cpu"), k, k)


def test_live_items_match_jax():
    jt, tt, items = _filled(seed=7)
    want = JHT.ht_live_items(jt)
    got = THT.ht_live_items(tt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) == len(items)


# ------------------------------------------- the multi-segment probe call

def _probe_cases():
    """{case: [(filled-table seed, cap), ...]}: the segments of one call,
    each a table filled by the same insert sequence in both packages."""
    return {
        "one table": [(5, 1 << 10)],
        "two tables": [(5, 1 << 10), (9, 1 << 11)],
        "one table twice": [(5, 1 << 10), (5, 1 << 10)],
    }


@pytest.mark.parametrize("case", sorted(_probe_cases()))
def test_fused_probe_multi_cpu_path_matches_jax_lookups(case):
    """Each segment of one ht_lookup_fused_multi call equals the JAX
    package's ht_lookup on its own table: present, orphaned, absent,
    zero and bit-edge keys (the edge keys are inserted, or masked off
    and so absent, in _filled's first batch)."""
    segs, wants = [], []
    for i, (seed, cap) in enumerate(_probe_cases()[case]):
        jt, tt, items = _filled(cap=cap, seed=seed)
        q_hi, q_lo = _queries(items, np.random.default_rng(20 + i))
        e_hi, e_lo = _edge_keys()
        q_hi = np.concatenate([q_hi, e_hi])
        q_lo = np.concatenate([q_lo, e_lo])
        wants.append(JHT.ht_lookup(jt, jnp.asarray(q_hi), jnp.asarray(q_lo)))
        segs.append((tt, _t(q_hi), _t(q_lo)))
    before = fused_probe.LAUNCHES
    got = fused_probe.ht_lookup_fused_multi(segs)
    assert fused_probe.LAUNCHES == before
    assert len(got) == len(segs)
    for (got_f, got_v), (want_f, want_v), seg in zip(got, wants, segs):
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        assert got_v.dtype == torch.int32 and got_f.dtype == torch.bool
        one_f, one_v = fused_probe.ht_lookup_fused(*seg)
        assert torch.equal(one_f, got_f) and torch.equal(one_v, got_v)


def test_fused_probe_multi_with_an_empty_segment():
    _, tt, items = _filled(seed=5)
    q_hi, q_lo = _queries(items, np.random.default_rng(6))
    empty = torch.zeros(0, dtype=torch.int64)
    (f0, v0), (f1, v1) = fused_probe.ht_lookup_fused_multi(
        [(tt, empty, empty), (tt, _t(q_hi), _t(q_lo))])
    assert f0.shape == v0.shape == (0,)
    want_f, want_v = THT.ht_lookup(tt, _t(q_hi), _t(q_lo))
    assert torch.equal(f1, want_f) and torch.equal(v1, want_v)


def _bad_probe_calls():
    tt = THT.ht_init(64, device="cpu")
    k = torch.zeros(4, dtype=torch.int64)
    strided = dict(packed=tt["packed"].T.contiguous().T)
    return {
        "three segments": ([(tt, k, k)] * 3, "1 to 2"),
        "no segment": ([], "1 to 2"),
        "keys on another device": ([(tt, k, k), (tt, k.to("meta"), k)],
                                   "one CUDA device"),
        "a table on another device": (
            [(tt, k, k), (THT.ht_init(64, device="meta"), k, k)],
            "one CUDA device"),
        "a strided table": ([(tt, k, k), (strided, k, k)], "contiguous"),
        "int32 keys": ([(tt, k.to(torch.int32), k)], "int64"),
        "unequal key halves": ([(tt, k, k[:3])], "equal-length"),
        "a table not (B+1, 24)": ([(dict(packed=tt["packed"][:, :16]
                                         .contiguous()), k, k)],
                                  "is not"),
    }


@pytest.mark.parametrize("case", sorted(_bad_probe_calls()))
def test_fused_probe_multi_refuses_what_the_kernel_does_not_take(case):
    segments, match = _bad_probe_calls()[case]
    with pytest.raises(ValueError, match=match):
        fused_probe.ht_lookup_fused_multi(segments)
