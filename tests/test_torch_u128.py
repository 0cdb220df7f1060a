"""Port parity: u128 limb arithmetic and the fast-kernel limb helpers.

Every function of the port's `ops/u128.py` (u64 lanes carried as int64)
and the limb helpers of its `ops/fast_kernels.py` run on the same inputs
as the JAX package's, made from a numpy seed: random values plus the
bit edges 0, 1, 2^32-1, 2^32, 2^63-1, 2^63 and 2^64-1 in every limb.
Every comparison is exact (integer arithmetic: tolerance 0).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.ops import fast_kernels as JFK
from tigerbeetle_tpu.ops import u128 as JU
from tigerbeetle_tpu_torch.ops import fast_kernels as TFK
from tigerbeetle_tpu_torch.ops import u128 as TU
from tigerbeetle_tpu_torch.ops import u64 as T64

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

EDGES = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1],
                 dtype=np.uint64)


@pytest.fixture(autouse=True)
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _operands(seed=0, n_rand=200):
    """(a_hi, a_lo, b_hi, b_lo) uint64 arrays: every edge combination of
    the four limbs' edge values, then random limbs."""
    rng = np.random.default_rng(seed)
    combos = np.array(list(itertools.product(range(len(EDGES)), repeat=2)))
    e_hi = EDGES[combos[:, 0]]
    e_lo = EDGES[combos[:, 1]]
    m = len(e_hi)
    # Pair every edge value with every other (a x b over the edge set).
    a_idx, b_idx = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    a_hi = e_hi[a_idx.ravel()]
    a_lo = e_lo[a_idx.ravel()]
    b_hi = e_hi[b_idx.ravel()]
    b_lo = e_lo[b_idx.ravel()]
    r = rng.integers(0, 2**64 - 1, (4, n_rand), dtype=np.uint64,
                     endpoint=True)
    return [np.concatenate([x, y]) for x, y in
            zip((a_hi, a_lo, b_hi, b_lo), r)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.uint64).view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64) if t.dtype == torch.int64 \
        else t.numpy()


def _same(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), np.asarray(w))


@pytest.mark.parametrize("name", ["add", "sub", "lt", "le", "eq", "min_",
                                  "sat_sub"])
def test_binary_u128_ops_match_jax(name):
    ops = _operands()
    want = getattr(JU, name)(*(jnp.asarray(o) for o in ops))
    got = getattr(TU, name)(*(_t(o) for o in ops))
    _same(got, want)


def test_add3_and_select_match_jax():
    a = _operands(1)
    b = _operands(2)
    want = JU.add3(*(jnp.asarray(o) for o in a),
                   jnp.asarray(b[0]), jnp.asarray(b[1]))
    got = TU.add3(*(_t(o) for o in a), _t(b[0]), _t(b[1]))
    _same(got, want)
    cond = np.random.default_rng(3).random(len(a[0])) < 0.5
    want = JU.select(jnp.asarray(cond), *(jnp.asarray(o) for o in a))
    got = TU.select(torch.from_numpy(cond), *(_t(o) for o in a))
    _same(got, want)


@pytest.mark.parametrize("name", ["is_zero", "is_max"])
def test_unary_u128_predicates_match_jax(name):
    hi, lo = _operands()[:2]
    want = getattr(JU, name)(jnp.asarray(hi), jnp.asarray(lo))
    got = getattr(TU, name)(_t(hi), _t(lo))
    _same(got, want)


def test_int_conversions_roundtrip():
    vals = [0, 1, 2**64 - 1, 2**64, 2**127, 2**128 - 1,
            0x0123456789ABCDEF_FEDCBA9876543210]
    for v in vals:
        hi, lo = TU.from_int(v)
        assert TU.to_int(hi, lo) == v
        j_hi, j_lo = JU.from_int(v)
        assert (hi & T64.MASK64, lo & T64.MASK64) == (int(j_hi), int(j_lo))
    hi, lo = TU.from_ints(vals)
    j_hi, j_lo = JU.from_ints(vals)
    np.testing.assert_array_equal(hi.view(np.uint64), j_hi)
    np.testing.assert_array_equal(lo.view(np.uint64), j_lo)


@pytest.mark.parametrize("k", [1, 27, 29, 30, 31, 32, 63])
def test_logical_shift_matches_u64(k):
    x = np.concatenate([EDGES, np.random.default_rng(k).integers(
        0, 2**64 - 1, 300, dtype=np.uint64, endpoint=True)])
    got = T64.srl(_t(x), k)
    np.testing.assert_array_equal(_u(got), x >> np.uint64(k))


def test_unsigned_order_helpers_match_u64():
    a, b = _operands()[1], _operands()[3]
    ta, tb = _t(a), _t(b)
    for fn, ref in ((T64.ult, np.less), (T64.ule, np.less_equal),
                    (T64.ugt, np.greater)):
        np.testing.assert_array_equal(fn(ta, tb).numpy(), ref(a, b))
    np.testing.assert_array_equal(_u(T64.umax(ta, tb)), np.maximum(a, b))
    np.testing.assert_array_equal(_u(T64.umin(ta, tb)), np.minimum(a, b))
    assert T64.u64(T64.umax_reduce(ta)) == int(a.max())
    assert T64.u64(T64.umin_reduce(ta)) == int(a.min())
    np.testing.assert_array_equal(_u(T64.ucummin(ta, 0)),
                                  np.minimum.accumulate(a))


def test_wrapping_multiplication_matches_u64():
    x = np.concatenate([EDGES, np.random.default_rng(9).integers(
        0, 2**64 - 1, 300, dtype=np.uint64, endpoint=True)])
    for c in (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB):
        got = _t(x) * T64.s64(c)
        np.testing.assert_array_equal(_u(got), x * np.uint64(c))


# ------------------------------------------------ fast-kernel limb helpers

@pytest.mark.parametrize("name", ["_to_limbs", "_neg_limbs"])
def test_limb_split_helpers_match_jax(name):
    hi, lo = _operands()[:2]
    want = getattr(JFK, name)(jnp.asarray(hi), jnp.asarray(lo))
    got = getattr(TFK, name)(_t(hi), _t(lo))
    _same(got, want)


def test_from_limbs_roundtrip_matches_jax():
    hi, lo = _operands()[:2]
    limbs = JFK._to_limbs(jnp.asarray(hi), jnp.asarray(lo))
    want = JFK._from_limbs(*limbs)
    got = TFK._from_limbs(*(_t(np.asarray(x)) for x in limbs))
    _same(got, want)
    _same(got, (hi, lo))


def test_u128_max_reduce_matches_jax():
    ops = _operands(4)
    his = [ops[0], ops[2], ops[0][::-1].copy()]
    los = [ops[1], ops[3], ops[3][::-1].copy()]
    want = JFK._u128_max_reduce([jnp.asarray(h) for h in his],
                                [jnp.asarray(l) for l in los])
    got = TFK._u128_max_reduce([_t(h) for h in his], [_t(l) for l in los])
    assert [T64.u64(g) for g in got] == [int(w) for w in want]


def test_normalize_limbs_matches_jax():
    rng = np.random.default_rng(5)
    # Un-normalized limb stacks as the kernels build them: base limbs
    # (< 2^32) plus prefix sums of up to 2N u32 lanes (< 2^46).
    limbs = rng.integers(0, 2**46, (4, 4, 64), dtype=np.uint64)
    limbs[:, :, :8] = np.uint64(2**32 - 1)
    want = JFK._normalize_limbs(jnp.asarray(limbs))
    got = TFK._normalize_limbs(_t(limbs))
    _same(got, want)


@pytest.mark.parametrize("name", ["_cumsum", "_cummin", "_cummax"])
def test_cumulative_helpers_match_jax(name):
    x = np.random.default_rng(6).integers(-2**31, 2**31, (3, 50),
                                          dtype=np.int64)
    want = getattr(JFK, name)(jnp.asarray(x), axis=1)
    got = getattr(TFK, name)(torch.from_numpy(x), dim=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_delta_lanes_match_jax():
    rng = np.random.default_rng(7)
    n = 40
    masks = [rng.random(n) < 0.4 for _ in range(4)]
    masks[2] &= ~masks[1]  # pending and post/void are disjoint
    hi, lo = rng.integers(0, 2**64 - 1, (2, n), dtype=np.uint64,
                          endpoint=True)
    al = JFK._to_limbs(jnp.asarray(hi), jnp.asarray(lo))
    nl = JFK._neg_limbs(jnp.asarray(lo), jnp.asarray(hi))
    want = JFK._delta_lanes2(*(jnp.asarray(m) for m in masks), al, nl)
    got = TFK._delta_lanes2(*(torch.from_numpy(m) for m in masks),
                            [_t(np.asarray(x)) for x in al],
                            [_t(np.asarray(x)) for x in nl])
    np.testing.assert_array_equal(_u(got), np.asarray(want))


def test_packed_perm_matches_jax():
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 300, 128).astype(np.int32)
    order = np.concatenate([np.arange(64), np.arange(64)]).astype(np.int32)
    want = JFK._packed_perm(jnp.asarray(rows), jnp.asarray(order), 301)
    got = TFK._packed_perm(torch.from_numpy(rows.astype(np.int64)),
                           torch.from_numpy(order.astype(np.int64)), 301)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dup_keys_matches_jax():
    rng = np.random.default_rng(10)
    for trial in range(6):
        k_hi = rng.integers(0, 3, 60).astype(np.uint64) << np.uint64(62)
        k_lo = rng.integers(0, 40, 60).astype(np.uint64)
        tags = rng.random(60) < (0.2 + 0.15 * trial)
        want = bool(JFK._dup_keys(jnp.asarray(k_hi), jnp.asarray(k_lo),
                                  jnp.asarray(tags)))
        got = bool(TFK._dup_keys(_t(k_hi), _t(k_lo),
                                 torch.from_numpy(tags)))
        assert got == want
