"""The port's row gather (`ops/row_gather.py`) on the CPU.

Its plain twin is held, exactly, against the reference of the eight TPU
gather probes it replaces (`onchip/gather_probe.py`,
`onchip/gather_probe2.py`): `jnp.take(table, rows, axis=0)` and, for the
16-bit-limb probes, `jnp.take(table & 0xFFFF, rows, axis=0)`, at the
probes' own (4097, 48) u32 shape. The probe scripts themselves are not
imported: they run their lowering attempts at import time.

The wrapper's contract is checked here too: it refuses what the CUDA
kernel does not take (dtype, rank, strides, mixed devices), and a CPU
tensor runs the plain twin without building or loading the library.
The kernel itself runs only on the card (`chip_smoke.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu_torch.ops import _build
from tigerbeetle_tpu_torch.ops import row_gather as RG

B, W, N = 4097, 48, 8192


@pytest.fixture(autouse=True)
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture(autouse=True)
def _no_library(monkeypatch):
    """On the CPU the wrapper never builds or loads the CUDA library."""
    def refuse():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")
    monkeypatch.setattr(_build, "load_row_gather", refuse)
    before = RG.LAUNCHES
    yield
    assert RG.LAUNCHES == before
    assert "row_gather" not in _build._libs


def _probe_table():
    """The probes' table: arange(4097 * 48) as u32, (4097, 48)."""
    return np.arange(B * W, dtype=np.uint32).reshape(B, W)


def _probe_rows():
    """The probes' rows: (arange(8192) * 7) % 4097 as int32."""
    return ((np.arange(N) * 7) % B).astype(np.int32)


def _random_table(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (B, W), dtype=np.uint64).astype(np.uint32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _gather(table_u32: np.ndarray, rows: np.ndarray, mask=None):
    out = RG.row_gather(torch.from_numpy(table_u32.view(np.int32)),
                        torch.from_numpy(rows), mask)
    assert out.dtype == torch.int32 and out.shape == (len(rows), W)
    return _u32(out)


@pytest.mark.parametrize("rows_kind", ["probe", "random"])
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("mask", [None, 0xFFFFFFFF, 0xFFFF])
def test_plain_twin_matches_the_probes_reference(rows_kind, index_dtype,
                                                 mask):
    table = _probe_table() if rows_kind == "probe" else _random_table(3)
    rows = (_probe_rows() if rows_kind == "probe"
            else np.random.default_rng(4).integers(0, B, N)).astype(
                index_dtype)
    src = jnp.asarray(table)
    if mask == 0xFFFF:
        src = src & jnp.uint32(0xFFFF)
    want = np.asarray(jnp.take(src, jnp.asarray(rows), axis=0))
    np.testing.assert_array_equal(_gather(table, rows, mask), want)


def test_out_of_range_rows_clamp_as_jax_indexing_does():
    table = _random_table(5)
    rng = np.random.default_rng(6)
    # Above the table: JAX's table[rows] clamps to the last row. (JAX
    # gathers with int32 offsets, so int64 rows stay in the int32 range
    # here; the kernel clamps any int64 row.)
    high = np.concatenate([rng.integers(B, 2**31 - 1, 500),
                           [B, B + 1, 2**31 - 1]]).astype(np.int64)
    np.testing.assert_array_equal(
        _gather(table, high),
        np.asarray(jnp.asarray(table)[jnp.asarray(high)]))
    high32 = rng.integers(B, 2**31 - 1, 500).astype(np.int32)
    np.testing.assert_array_equal(
        _gather(table, high32),
        np.asarray(jnp.asarray(table)[jnp.asarray(high32)]))
    # Below -B: JAX wraps once, is still below 0 and clamps to row 0, as
    # the kernel does. (A row in [-B, 0) wraps under table[rows] but
    # clamps to row 0 here; no gather of the path ever gives one.)
    low = np.concatenate([rng.integers(-(2**31) + 1, -B, 500),
                          [-B - 1, -(2**31) + 1]]).astype(np.int64)
    np.testing.assert_array_equal(
        _gather(table, low),
        np.asarray(jnp.asarray(table)[jnp.asarray(low)]))
    np.testing.assert_array_equal(
        _gather(table, np.array([-1, -B, -2**62], dtype=np.int64)),
        np.broadcast_to(table[0], (3, W)))
    np.testing.assert_array_equal(
        _gather(table, np.array([2**40, 2**63 - 1], dtype=np.int64)),
        np.broadcast_to(table[B - 1], (2, W)))


def test_int64_table_through_its_int32_view():
    """What the kernel does with a u64 store: gather the (B, 2W) int32
    view and view the result back. Equal to the int64 gather."""
    rng = np.random.default_rng(7)
    t64 = torch.from_numpy(
        rng.integers(0, 1 << 64, (1025, 24), dtype=np.uint64).view(np.int64))
    t64[0, 0] = -1
    t64[1, 1] = -(1 << 63)
    rows = torch.from_numpy(rng.integers(-5, 1100, 3000))
    want = t64[rows.clamp(0, 1024)]
    got = RG.row_gather(t64, rows)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    via_view = RG.row_gather_plain(t64.view(torch.int32), rows)
    assert via_view.shape == (3000, 48)
    assert torch.equal(via_view.view(torch.int64), want)


def test_empty_rows_and_one_row_table():
    table = torch.arange(12, dtype=torch.int32).reshape(1, 12)
    out = RG.row_gather(table, torch.empty(0, dtype=torch.int64))
    assert out.shape == (0, 12)
    out = RG.row_gather(table, torch.tensor([-3, 0, 9], dtype=torch.int32))
    assert torch.equal(out, table.expand(3, 12))


def _bad_calls():
    t32 = torch.zeros((64, 8), dtype=torch.int32)
    t64 = torch.zeros((64, 8), dtype=torch.int64)
    rows = torch.arange(10)
    return {
        "float table": (t32.float(), rows, None, "table must be"),
        "int16 table": (t32.to(torch.int16), rows, None, "table must be"),
        "1-D table": (t32[:, 0].contiguous(), rows, None, "table must be"),
        "transposed table": (t64.T, rows, None, "contiguous"),
        "column-sliced table": (t64[:, :4], rows, None, "contiguous"),
        "int16 rows": (t32, rows.to(torch.int16), None, "rows must be"),
        "2-D rows": (t32, rows.reshape(2, 5), None, "rows must be"),
        "strided rows": (t32, rows[::2], None, "rows must be contiguous"),
        "mask on int64": (t64, rows, 0xFFFF, "32-bit tables only"),
        "mask too wide": (t32, rows, 1 << 32, "not a 32-bit word"),
        "empty table": (t32[:0], rows, None, "no rows"),
        "rows on another device": (t32, rows.to("meta"), None,
                                   "one CUDA device"),
        "table on another device": (t32.to("meta"), rows, None,
                                    "one CUDA device"),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    table, rows, mask, match = _bad_calls()[case]
    with pytest.raises(ValueError, match=match):
        RG.row_gather(table, rows, mask)


# ----------------------------------------------- multi-segment launches

def _store(seed, rows, width, dtype):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 64, (rows, width), dtype=np.uint64)
    if dtype == np.int32:
        return bits.astype(np.uint32).view(np.int32)
    return bits.view(np.int64)


def _rows(seed, n, hi, dtype, lo=0):
    return np.random.default_rng(seed).integers(lo, hi, n).astype(dtype)


def _multi_cases():
    """{case: (tables, rows (one shared array or one per table), masks)}
    in numpy: the widths of the main path's stores (16 and 20 int64
    lanes) and of the probes' table (48 int32 words, with the 16-bit
    mask), one to four segments."""
    bal = _store(11, 1025, 16, np.int64)
    xfr = _store(12, 2049, 20, np.int64)
    probe = _store(13, B, W, np.int32)
    shared = np.concatenate([_rows(14, 3000, 1025, np.int64),
                             [-1, -2**40, 1025, 2**40, 0, 1024]])
    return {
        "one masked int32": ([probe], _rows(15, N, B, np.int32), [0xFFFF]),
        "two sharing rows": ([bal, _store(16, 1025, 8, np.int64)], shared,
                             None),
        "three own rows": ([bal, xfr, probe],
                           [_rows(17, 500, 1025, np.int32),
                            _rows(18, 700, 4000, np.int64, lo=-2000),
                            _rows(19, 900, B + 50, np.int64)],
                           [None, None, 0xFFFF]),
        "four with an empty one": ([xfr, bal, probe, probe],
                                   [_rows(20, 300, 2049, np.int64),
                                    np.zeros(0, dtype=np.int64),
                                    _rows(21, 400, B, np.int32),
                                    np.array([-5, B, 2**31 - 1, 7],
                                             dtype=np.int32)],
                                   [None, None, 0xFFFF, 0xFFFFFFFF]),
        "four sharing clamped rows": ([bal, xfr, probe, probe],
                                      np.array([-(2**62), -1, 0, 1, 1024,
                                                2048, B - 1, B, 2**62],
                                               dtype=np.int64),
                                      [None, None, None, 0xFFFF]),
    }


@pytest.mark.parametrize("case", sorted(_multi_cases()))
def test_multi_plain_twin_equals_numpy_and_the_one_segment_gather(case):
    tables, rows, masks = _multi_cases()[case]
    per_rows = rows if isinstance(rows, list) else [rows] * len(tables)
    per_masks = masks or [None] * len(tables)
    t_tables = [torch.from_numpy(t) for t in tables]
    t_rows = (torch.from_numpy(rows) if not isinstance(rows, list)
              else [torch.from_numpy(r) for r in rows])
    got = RG.row_gather_multi(t_tables, t_rows, masks)
    plain = RG.row_gather_multi_plain(t_tables, t_rows, masks)
    assert len(got) == len(plain) == len(tables)
    for t, r, m, g, p in zip(tables, per_rows, per_masks, got, plain):
        want = t[np.clip(r, 0, t.shape[0] - 1)]
        if m is not None:
            want = want & np.array(m, dtype=np.uint32).view(np.int32)
        assert g.dtype == torch.from_numpy(t).dtype
        np.testing.assert_array_equal(g.numpy(), want)
        assert torch.equal(p, g)
        one = RG.row_gather(torch.from_numpy(t), torch.from_numpy(r), m)
        assert torch.equal(one, g)


def _bad_multi_calls():
    t32 = torch.zeros((64, 8), dtype=torch.int32)
    t64 = torch.zeros((64, 8), dtype=torch.int64)
    rows = torch.arange(10)
    return {
        "five segments": ([t32] * 5, rows, None, "1 to 4"),
        "no segment": ([], rows, None, "1 to 4"),
        "rows for the wrong count": ([t32, t64], [rows] * 3, None,
                                     "row sets"),
        "masks for the wrong count": ([t32, t32], rows, [0xFFFF], "masks"),
        "a table on another device": ([t32, t64.to("meta")], rows, None,
                                      "one CUDA device"),
        "rows on another device": ([t32, t64], [rows, rows.to("meta")],
                                   None, "one CUDA device"),
        "all on another device": ([t32.to("meta")], rows.to("meta"), None,
                                  "one CUDA device"),
        "a strided table": ([t32, t64.T], rows, None, "contiguous"),
        "a mask on an int64 table": ([t32, t64], rows, [0xFFFF, 0xFFFF],
                                     "32-bit tables only"),
    }


@pytest.mark.parametrize("case", sorted(_bad_multi_calls()))
def test_multi_wrapper_refuses_what_the_kernel_does_not_take(case):
    tables, rows, masks, match = _bad_multi_calls()[case]
    with pytest.raises(ValueError, match=match):
        RG.row_gather_multi(tables, rows, masks)


def test_ledger_lookups_gather_each_store_in_one_call(monkeypatch):
    """lookup_accounts reads the balance and meta matrices in one
    row-gather call (one launch on the card), lookup_transfers its one
    matrix; both still give what was created."""
    from tigerbeetle_tpu_torch import DeviceLedger
    from tigerbeetle_tpu_torch.ops import ledger
    from tigerbeetle_tpu_torch.types import Account, Transfer

    led = DeviceLedger(a_cap=1 << 8, t_cap=1 << 10, device="cpu")
    led.create_accounts([Account(id=i, ledger=1, code=1)
                         for i in (1, 2, 2**127 + 5)], 100)
    led.create_transfers([Transfer(id=77, debit_account_id=1,
                                   credit_account_id=2**127 + 5, amount=5,
                                   ledger=1, code=1)], 200)
    calls = []

    def counted(tables, rows, masks=None):
        calls.append(len(tables))
        return RG.row_gather_multi(tables, rows, masks)

    monkeypatch.setattr(ledger, "row_gather_multi", counted)
    accts = led.lookup_accounts([2**127 + 5, 3, 1])
    assert [a.id for a in accts] == [2**127 + 5, 1]
    assert accts[0].credits_posted == 5 and accts[1].debits_posted == 5
    assert calls == [2]
    xfers = led.lookup_transfers([77, 78])
    assert [(t.id, t.amount) for t in xfers] == [(77, 5)]
    assert calls == [2, 1]
