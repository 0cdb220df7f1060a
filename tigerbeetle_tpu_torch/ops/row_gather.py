"""Row gather: a hand-written CUDA kernel for Hopper, up to 4 tables a
launch.

`row_gather(table, rows, mask)` is `table[clamp(rows, 0, B - 1)] & mask`
over a contiguous (B, W) table of 32- or 64-bit words: every row gather
of the create_transfers path (the account and transfer role gathers,
the in-window pending view, the balance bases, the insert plan's bucket
rows, the ledger's lookups). `row_gather_multi(tables, rows, masks)` is
the same for up to 4 (table, rows, mask) segments in ONE launch, the
segments free to share one rows array: the account-role gather reads
the balance and the meta matrix at one row set, and the ledger's
lookups read every store matrix at one.

It replaces the eight Pallas TPU kernels that are formulations of this
one function on a (4097, 48) u32 table at 8,192 rows:
`onchip/gather_probe.py:31` k_take, `:35` k_taa, `:40` k_loop, `:47`
k_onehot (low 16-bit limb), `onchip/gather_probe2.py:31` k_smem_loop,
`:56` k_taa32, `:74` k_onehot32 (low 16-bit limb) and `:101` k_blk.
None of them lowered on the TPU, so the JAX package gathers with XLA's
`x[rows]`; the port's kernel is `csrc/row_gather.cu`, built with nvcc
for sm_90a at first use and bound with ctypes (`_build.py`).

What bounds it on an H100 at the main path's sizes is latency, not
bytes: the bytes (output written once, each distinct gathered row read
once in 32-byte sectors, indexes read once) take ~0.0016 ms at 3.35
TB/s for the transfer gather, less than a launch and two dependent
device-memory round trips (chip_smoke.py on an H100 80GB HBM3 at 700 W:
one row 0.0014–0.0019 ms, the transfer gather 0.0033 ms; PERF.md).
Hence one launch for the tables of one stage,
16-byte loads through the read-only path and a grid of at most one wave
(see the source note), and a launch path here that does little on the
host: the C entry
point is resolved once, the segment structures are filled with ctypes
directly, the stream is read as a raw handle (no Stream object is made),
and the checks are direct comparisons.

An int64 table is gathered as 32-bit words (twice the width), which is
what the probes planned for the u64 stores; that needs a contiguous
table, so a strided one raises. A mask applies to 32-bit words only, so
it is refused on an int64 table.

Routing is by the device of the tensors alone: CUDA tensors launch the
kernel (or raise), CPU tensors run the plain twin. `LAUNCHES` counts
kernel launches and nothing else. `COST`, None but while the
observatory's cost model counts a tier run (`trace/profiler.py`), takes
each call and charges it `bound_bytes`: a dispatch mode sees no kernel.
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = 0
COST = None

SECTOR_BYTES = 32           # the least a read from device memory moves
FULL_MASK = 0xFFFFFFFF
MAX_SEGMENTS = 4
_INDEX_DTYPES = (torch.int32, torch.int64)
_TABLE_DTYPES = (torch.int32, torch.int64)

_launch = None  # the C entry point, resolved at the first launch


def _check(table, rows, mask) -> None:
    if table.dtype not in _TABLE_DTYPES or table.dim() != 2:
        raise ValueError(f"row_gather: table must be a 2-D int32 or int64 "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError("row_gather: table must be contiguous (its rows "
                         "are read as 32-bit words)")
    if table.shape[0] < 1:
        raise ValueError("row_gather: table has no rows")
    if rows.dtype not in _INDEX_DTYPES or rows.dim() != 1:
        raise ValueError(f"row_gather: rows must be a 1-D int32 or int64 "
                         f"tensor, got {rows.dtype} {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError("row_gather: rows must be contiguous")
    if mask is not None:
        if not 0 <= mask <= FULL_MASK:
            raise ValueError(f"row_gather: mask {mask:#x} is not a 32-bit "
                             "word")
        if table.dtype != torch.int32 and mask != FULL_MASK:
            raise ValueError("row_gather: a mask applies to 32-bit tables "
                             "only")


def _segments(tables, rows, masks):
    """(tables, per-table rows, per-table masks) as lists of one length
    between 1 and MAX_SEGMENTS; `rows` is one tensor shared by every
    table or a sequence of one per table, `masks` None or a sequence."""
    tables = list(tables)
    n = len(tables)
    if not 1 <= n <= MAX_SEGMENTS:
        raise ValueError(f"row_gather: {n} segments; one launch takes 1 to "
                         f"{MAX_SEGMENTS}")
    rows = list(rows) if isinstance(rows, (list, tuple)) else [rows] * n
    masks = [None] * n if masks is None else list(masks)
    if len(rows) != n or len(masks) != n:
        raise ValueError(f"row_gather: {n} tables, {len(rows)} row sets, "
                         f"{len(masks)} masks")
    return tables, rows, masks


def _signed32(mask: int) -> int:
    return mask - (1 << 32) if mask >> 31 else mask


def row_gather_plain(table, rows, mask=None):
    """The plain PyTorch twin: table[rows.clamp(0, B - 1)] & mask."""
    out = table[rows.clamp(0, table.shape[0] - 1)]
    if mask is not None and mask != FULL_MASK:
        out = out & _signed32(mask)
    return out


def row_gather_multi_plain(tables, rows, masks=None):
    """The plain twin of `row_gather_multi`: one `row_gather_plain` a
    segment."""
    return [row_gather_plain(t, r, m)
            for t, r, m in zip(*_segments(tables, rows, masks))]


def row_gather_multi(tables, rows, masks=None):
    """Gather each of `tables` (at most MAX_SEGMENTS) at its rows
    (clamped), masked per 32-bit word by its mask (None: every bit), in
    ONE kernel launch. `rows` is one index tensor shared by every table
    or a sequence of one per table. Returns the outputs in order."""
    if COST is not None:
        return COST.kernel("row_gather", _gather_multi, bound_bytes,
                           tables, rows, masks)
    return _gather_multi(tables, rows, masks)


def bound_bytes(tables, rows, masks, outs) -> int:
    """The bytes one gather must move (its PERF.md bound): each index
    set read once, and for each table the output written once and each
    distinct gathered row read once in 32-byte sectors (a masked gather
    reads the row's words all the same)."""
    tables, rows, masks = _segments(tables, rows, masks)
    total = sum(r.numel() * r.element_size()
                for r in {id(r): r for r in rows}.values())
    for t, r in zip(tables, rows):
        row_bytes = t.shape[1] * t.element_size()
        distinct = int(torch.unique(
            r.to(torch.int64).clamp(0, t.shape[0] - 1)).numel())
        sectors = -(-row_bytes // SECTOR_BYTES)
        total += r.numel() * row_bytes + distinct * sectors * SECTOR_BYTES
    return total


def _gather_multi(tables, rows, masks):
    global LAUNCHES, _launch
    tables, rows, masks = _segments(tables, rows, masks)
    dev = tables[0].device
    for t, r, m in zip(tables, rows, masks):
        _check(t, r, m)
        if t.device != dev or r.device != dev:
            raise ValueError(
                f"row_gather: tensors on {t.device} and {r.device} beside "
                f"{dev}; expected all on one CUDA device (or all on the "
                "CPU)")
    if dev.type == "cpu":
        return [row_gather_plain(t, r, m)
                for t, r, m in zip(tables, rows, masks)]
    if dev.type != "cuda":
        raise ValueError(f"row_gather: tensors on {dev}; expected all on "
                         "one CUDA device (or all on the CPU)")
    segs = (_build.RowGatherSegment * len(tables))()
    outs = []
    k = 0
    for t, r, m in zip(tables, rows, masks):
        n = r.shape[0]
        out = torch.empty((n, t.shape[1]), dtype=t.dtype, device=dev)
        outs.append(out)
        width = t.shape[1] * t.element_size() // 4
        if n == 0 or width == 0:
            continue
        s = segs[k]
        s.table = t.data_ptr()
        s.rows = r.data_ptr()
        s.out = out.data_ptr()
        s.n_rows = t.shape[0]
        s.n = n
        s.width = width
        s.rows_are_64 = r.dtype == torch.int64
        s.mask = FULL_MASK if m is None else m
        k += 1
    if k == 0:
        return outs
    if _launch is None:
        _launch = _build.load_row_gather()
    rc = _launch(segs, k, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: cudaError {rc}")
    LAUNCHES += 1
    return outs


def row_gather(table, rows, mask=None):
    """Gather rows of `table` at `rows` (clamped), masked per 32-bit
    word by `mask` (None: every bit): `row_gather_multi` of one
    segment."""
    return row_gather_multi((table,), rows,
                            None if mask is None else (mask,))[0]
